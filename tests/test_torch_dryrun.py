"""The port's multi-process dryrun (``tpusplat_torch.parallel.dryrun``) on the
CPU: ``run_dryrun(3)`` (mesh 1x3, three gloo processes, so the tile split
is exercised; every assertion of the JAX dryrun runs inside the ranks), the
one-process render of the dryrun's scene against the JAX ``render_stages``
within 3e-5, and the mesh layout."""

import dataclasses

import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.render import render_stages as jax_render_stages
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.parallel import dryrun
from tpusplat_torch.render import render_stages

torch.set_num_threads(2)


def test_run_dryrun_three_ranks():
    dryrun.run_dryrun(3, device="cpu")


@pytest.mark.parametrize("tile", [2, 3, 4])
def test_dryrun_scene_matches_jax(tile):
    """The scene and camera the dryrun's ranks make (``_scene``) render as
    the JAX dryrun's do."""
    width, height = 64, 16 * tile
    cfg_kw = dict(sh_degree=1, max_per_tile=2048, tile_chunk=4, gauss_chunk=16,
                  capacity_mult=16)
    params, cams = dryrun._scene(128 * tile, 0, width, height, 2, "cpu")
    for i, cam in enumerate(cams):
        img, aux = render_stages(params, cam, RenderConfig(**cfg_kw))
        ref, _ = jax_render_stages(
            jax_random_scene(128 * tile, seed=0, sh_degree=1, scale_range=(0.1, 0.5)),
            jax_look_at([np.sin(i), 0.3, 5.0], [0, 0, 0], width, height, fov_deg=60.0),
            JaxConfig(**cfg_kw))
        assert int(aux["capacity_overflow"]) == 0 and float(img.max()) > 0.05
        np.testing.assert_allclose(img.numpy(), np.asarray(ref), atol=3e-5)


@pytest.mark.parametrize("n,dims", [(1, (1, 1)), (2, (2, 1)), (3, (1, 3)), (4, (2, 2)),
                                    (6, (2, 3)), (8, (2, 4))])
def test_mesh_dims_and_compact_geometry(n, dims):
    """data = 2 for an even count (the JAX layout); the compact block's
    geometry keeps strip compaction on at every tile count from 2 up, and a
    mesh without a tile split is refused before any process starts."""
    assert dryrun.mesh_dims(n) == dims
    tile = dims[1]
    if tile < 2:
        with pytest.raises(ValueError, match="2 tile shards"):
            dryrun.run_dryrun(n, device="cpu")
        return
    width, height, margin, mult = dryrun.compact_geometry(tile)
    cfg = dataclasses.replace(RenderConfig(), strip_gauss_mult=1.5,
                              strip_gauss_margin_rows=margin, capacity_mult=mult)
    tiles_y = cfg.tile_grid(width, height)[1]
    n_pad = 4096 + (-4096 % tile)
    assert cfg.strip_gauss_capacity(n_pad, -(-tiles_y // tile), tiles_y) is not None
