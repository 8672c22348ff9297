"""The port's strip compaction (``bin_and_sort(..., gauss_capacity=...)``)
against the JAX package's, which compacts only on its Pallas emission path
(``use_pallas=True``, the emission kernel in interpret mode here): stream
ids, sorted gids and tile ids, tile ranges and every counter bit-equal, on a
stream cap that holds the strip and on one that overflows. The scene is
``tests/test_compact_grad.py``'s (4096 Gaussians, 128x256, SH1)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpusplat_torch import convert
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops import binning

torch.set_num_threads(2)

N, W, H = 4096, 128, 256  # 16 tile rows
FIELDS = ("gauss_id", "tile_id", "tile_start", "tile_end", "num_instances", "overflow",
          "gauss_overflow", "stream_ids")


@pytest.fixture(scope="module")
def jax_pg():
    from tpusplat.camera import look_at_camera
    from tpusplat.config import RenderConfig as JaxConfig
    from tpusplat.io.synthetic import random_scene
    from tpusplat.ops.preprocess import preprocess

    params = random_scene(N, seed=3, sh_degree=1, scale_range=(0.05, 0.3))
    cam = look_at_camera([0.0, 0.3, 6.0], [0, 0, 0], W, H, fov_deg=60.0)
    return preprocess(params, cam, JaxConfig(sh_degree=1))


def _torch_pg(pg):
    return convert.processed_from_numpy(
        **{f.name: np.asarray(getattr(pg, f.name)) for f in dataclasses.fields(pg)},
        device="cpu")


def _strip_visible_count(pg, row0, nrows):
    aabb = np.asarray(pg.aabb)
    y0 = np.clip(aabb[:, 1], row0, row0 + nrows)
    y1 = np.clip(aabb[:, 3], row0, row0 + nrows)
    return int(((np.asarray(pg.ntiles) > 0) & (y1 > y0)).sum())


@pytest.mark.parametrize("fits", [True, False])
@pytest.mark.parametrize("row0,nrows", [(6, 2), (0, 4)])
def test_compaction_matches_jax_pallas(jax_pg, row0, nrows, fits):
    from tpusplat.config import RenderConfig as JaxConfig
    from tpusplat.ops.binning import bin_and_sort as jax_bin_and_sort

    vis = _strip_visible_count(jax_pg, row0, nrows)
    assert 0 < vis < N - 100
    gcap = vis + 100 if fits else vis // 2
    cfg = JaxConfig(sh_degree=1, use_pallas=True)
    cap = 16 * 1024
    ref = jax.jit(lambda p: jax_bin_and_sort(p, W, H, cfg, row0, nrows, cap,
                                             gauss_capacity=gcap))(jax_pg)
    got = binning.bin_and_sort(_torch_pg(jax_pg), W, H, RenderConfig(sh_degree=1), row0,
                               nrows, cap, gauss_capacity=gcap)
    assert ref.stream_ids is not None and got.stream_ids.shape == (gcap,)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    stream = got.stream_ids.numpy()
    assert (stream[min(vis, gcap):] == N).all() and (stream[:min(vis, gcap)] < N).all()
    assert int(got.overflow) == 0
    assert (int(got.gauss_overflow) == 0) == fits


def test_compaction_keeps_the_strip_image_inputs(jax_pg):
    """With a cap that holds the strip, the compacted binning emits exactly
    the instances of the uncompacted one, in the same order."""
    pg = _torch_pg(jax_pg)
    cfg = RenderConfig(sh_degree=1)
    full = binning.bin_and_sort(pg, W, H, cfg, 6, 2, 16 * 1024)
    comp = binning.bin_and_sort(pg, W, H, cfg, 6, 2, 16 * 1024,
                                gauss_capacity=_strip_visible_count(jax_pg, 6, 2))
    assert full.stream_ids is None
    for f in ("gauss_id", "tile_id", "tile_start", "tile_end", "num_instances"):
        assert torch.equal(getattr(full, f), getattr(comp, f)), f
    assert int(comp.gauss_overflow) == 0


@pytest.mark.parametrize("gcap,nrows", [(N, 2), (None, 2), (1024, 16)])
def test_no_compaction_without_a_cap_below_n_or_a_window(jax_pg, gcap, nrows):
    got = binning.bin_and_sort(_torch_pg(jax_pg), W, H, RenderConfig(sh_degree=1), 0, nrows,
                               16 * 1024, gauss_capacity=gcap)
    assert got.stream_ids is None and int(got.gauss_overflow) == 0


def test_plain_backward_of_an_empty_strip_is_zero():
    """A strip that no instance reaches (the bottom strip of a sparse frame,
    on a 1x4 mesh): the plain backward blend gives zero gradients, as the
    kernel does, instead of differentiating a blend with no graph."""
    from tpusplat_torch.ops import rasterize

    cfg = RenderConfig(sh_degree=1)
    tiles_x, nrows = W // cfg.tile_w, 2
    crop_h = nrows * cfg.tile_h
    attr = torch.randn((rasterize.ATTR_ROWS, 64), generator=torch.Generator().manual_seed(0))
    empty = torch.zeros(tiles_x * nrows, dtype=torch.int32)
    img, tmap, _ = rasterize.blend_plain(attr, empty, empty, tiles_x, 12, W, crop_h, cfg)
    d = rasterize.backward_blend_plain(attr, empty, empty, img, tmap, torch.ones_like(img),
                                       torch.ones_like(tmap), tiles_x, 12, W, crop_h, cfg)
    assert not img.any() and d.shape == attr.shape and not d.any()
