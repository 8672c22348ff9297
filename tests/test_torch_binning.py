"""The port's binning against tpusplat.ops.binning on the same (JAX)
ProcessedGaussians: sorted ids, tile ids, tile ranges and counters must be
bit-equal, through the Pallas emission kernel (interpret mode) and the XLA
expansion alike, including forced overflow and an all-culled frame
(mirroring tests/test_emission.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.ops.binning import bin_and_sort as jax_bin_and_sort
from tpusplat.ops.binning import expand_instances as jax_expand_instances
from tpusplat.ops.preprocess import preprocess as jax_preprocess
from tpusplat_torch import convert
from tpusplat_torch.camera import look_at_camera
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.ops import binning, emission
from tpusplat_torch.ops.preprocess import preprocess

torch.set_num_threads(2)

W, H = 128, 96
BINNED_FIELDS = ("gauss_id", "tile_id", "tile_start", "tile_end", "num_instances",
                 "overflow", "gauss_overflow")


def _jax_pg(n, seed, srange=(0.01, 0.08)):
    params = jax_random_scene(n, seed=seed, sh_degree=0, scale_range=srange, extent=4.0)
    cam = jax_look_at([0.0, 0.5, 7.0], [0.0, 0.0, 0.0], W, H, fov_deg=60.0)
    return jax_preprocess(params, cam, JaxConfig(sh_degree=0))


def _port_pg(n, seed):
    """The port's own preprocess, for tests that need no JAX input."""
    params = random_scene(n, seed=seed, sh_degree=0, scale_range=(0.01, 0.08), extent=4.0,
                          device="cpu")
    cam = look_at_camera([0.0, 0.5, 7.0], [0.0, 0.0, 0.0], W, H, fov_deg=60.0, device="cpu")
    return preprocess(params, cam, RenderConfig(sh_degree=0))


def _torch_pg(pg):
    return convert.processed_from_numpy(
        **{f.name: np.asarray(getattr(pg, f.name)) for f in dataclasses.fields(pg)},
        device="cpu")


def _assert_binned_equal(got, ref):
    for f in BINNED_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,seed,srange", [
    (600, 1, (0.01, 0.08)),
    (2000, 2, (0.02, 0.3)),
])
def test_bin_and_sort_matches_jax(n, seed, srange, use_pallas):
    pg = _jax_pg(n, seed, srange)
    cfg = JaxConfig(sh_degree=0, use_pallas=use_pallas)
    ref = jax.jit(lambda p: jax_bin_and_sort(p, W, H, cfg))(pg)
    got = binning.bin_and_sort(_torch_pg(pg), W, H,
                               convert.config_from_fields(dataclasses.asdict(cfg)))
    assert int(got.num_instances) > 0
    _assert_binned_equal(got, ref)
    # Ranges tile the sorted stream: end[t] == start[t+1], empty = start == end.
    np.testing.assert_array_equal(got.tile_end.numpy()[:-1], got.tile_start.numpy()[1:])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bin_and_sort_overflow_matches_jax(use_pallas):
    pg = _jax_pg(2000, seed=3, srange=(0.05, 0.3))
    total = int(jnp.sum(pg.ntiles))
    cfg = JaxConfig(sh_degree=0, use_pallas=use_pallas, capacity=1024)
    assert total > 1024
    ref = jax.jit(lambda p: jax_bin_and_sort(p, W, H, cfg))(pg)
    got = binning.bin_and_sort(_torch_pg(pg), W, H,
                               convert.config_from_fields(dataclasses.asdict(cfg)))
    assert int(got.overflow) == total - 1024 and int(got.num_instances) == 1024
    _assert_binned_equal(got, ref)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bin_and_sort_all_culled_matches_jax(use_pallas):
    pg = _jax_pg(512, seed=1)
    pg = dataclasses.replace(pg, ntiles=jnp.zeros_like(pg.ntiles))
    cfg = JaxConfig(sh_degree=0, use_pallas=use_pallas)
    ref = jax.jit(lambda p: jax_bin_and_sort(p, W, H, cfg))(pg)
    got = binning.bin_and_sort(_torch_pg(pg), W, H,
                               convert.config_from_fields(dataclasses.asdict(cfg)))
    assert int(got.num_instances) == 0 and int(got.overflow) == 0
    assert (got.tile_id.numpy() == 2**31 - 1).all()
    assert (got.gauss_id.numpy() == 512).all()
    _assert_binned_equal(got, ref)


@pytest.mark.parametrize("row0,nrows", [(0, None), (0, 2), (2, 2), (4, 2)])
def test_expand_instances_matches_jax(row0, nrows):
    """Emission over row windows with local tile ids (the sharded slice's
    unit), against the JAX expand_instances."""
    pg = _jax_pg(1500, seed=7)
    key = jnp.where(pg.ntiles > 0, pg.depth, jnp.inf)
    order = jnp.argsort(key, stable=True)
    tiles_x, _ = JaxConfig().tile_grid(W, H)
    ref = jax.jit(lambda p, o: jax_expand_instances(p, tiles_x, 8192, row0, nrows, o))(
        pg, order)
    got = binning.expand_instances(_torch_pg(pg), tiles_x, 8192, row0, nrows,
                                   torch.tensor(np.asarray(order)))
    for name, a, b in zip(("tile", "gid", "total", "overflow", "gauss_dropped"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_row_window_partitions_instances():
    pg = _port_pg(800, seed=5)
    cfg = RenderConfig(capacity_mult=32)
    _, tiles_y = cfg.tile_grid(W, H)
    full = binning.bin_and_sort(pg, W, H, cfg)
    strips = [binning.bin_and_sort(pg, W, H, cfg, row0=r0, nrows=2)
              for r0 in range(0, tiles_y, 2)]
    assert sum(int(s.num_instances) for s in strips) == int(full.num_instances)


def test_emission_wrapper_uses_plain_version_on_cpu():
    pg = _port_pg(700, seed=9)
    tiles_x, _ = JaxConfig().tile_grid(W, H)
    meta = binning.depth_sorted_meta(pg)
    before = emission.LAUNCHES
    got = emission.emit_instances(*meta, tiles_x, 4096, 0, 700)
    want = binning.expand_instances_sorted(*meta, tiles_x, 4096, 0, 700)
    assert emission.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
