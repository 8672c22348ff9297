"""The port's segment reduce against the JAX package's Pallas segment reduce
(``rasterize_pallas._run_segment_reduce`` in interpret mode, called as
``_pack_gather_bwd`` calls it: rows padded to GPAD rows and a window, bounds
at GB multiples), on the run shapes the CUDA kernel treats apart: short runs
summed by one lane each, one run long enough for the whole warp, mostly empty
runs, and a tail of sentinel ids holding NaN. On the CPU the port runs the
plain version (``index_add_``), so these cases hold the plain version and the
JAX side's padding on those shapes; the card's kernel, its paths included,
is held to the plain version only by chip_smoke.py.

Tolerance: atol 1e-4 and rtol 1e-5, the two sums taking their float32 adds
in different orders (the longest run sums 1500 standard-normal rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.ops import rasterize_pallas as rp
from tpusplat.ops.binning import _SUB, searchsorted_left, searchsorted_left_big
from tpusplat_torch.ops import segment_reduce

torch.set_num_threads(2)


def _case(name, rng):
    """(rows [9, R] float32, sorted gid [R] int32, N) of one case."""
    if name == "short_runs":  # every run 0-3 rows
        n = 4000
        counts = rng.integers(0, 4, n)
    elif name == "long_run":  # one run of 1500 rows among short ones
        n = 2000
        counts = rng.integers(0, 4, n)
        counts[777] = 1500
    elif name == "mostly_empty":  # 90% of the runs empty
        n = 4096
        counts = np.where(rng.random(n) < 0.1, rng.integers(1, 9, n), 0)
    else:  # "nan_sentinels": a tail of sentinel ids N whose rows hold NaN
        n = 3000
        counts = rng.integers(0, 3, n)
    gid = np.repeat(np.arange(n, dtype=np.int32), counts)
    if name == "nan_sentinels":
        gid = np.concatenate([gid, np.full(700, n, np.int32)])
    rows = rng.normal(size=(9, gid.shape[0])).astype(np.float32)
    rows[:, gid == n] = np.nan
    assert n <= 4096 and gid.shape[0] <= 8192
    return rows, gid, n


def _jax_reduce(rows, gid, n):
    """``_pack_gather_bwd``'s call of the Pallas reduce on sorted rows."""
    c = gid.shape[0]
    n_pad = -(-n // (rp.GB * rp.SEGG)) * (rp.GB * rp.SEGG)
    qs = jnp.minimum(jnp.arange(n_pad // rp.GB + 1, dtype=jnp.int32) * rp.GB, n)
    search = searchsorted_left_big if c % _SUB == 0 else searchsorted_left
    bounds = search(jnp.asarray(gid), qs)
    win = rp._seg_win(c, n_pad)
    grad = jnp.pad(jnp.asarray(rows), ((0, rp.GPAD - rp.GROWS), (0, win)))
    gid2d = jnp.pad(jnp.asarray(gid)[None, :], ((0, 0), (0, win)), constant_values=-1)
    out = jax.jit(lambda g, i, b: rp._run_segment_reduce(g, i, b, n_pad, n, win=win))(
        grad, gid2d, bounds)
    return np.asarray(out)[:rp.GROWS, :n]


@pytest.mark.parametrize("name", ["short_runs", "long_run", "mostly_empty", "nan_sentinels"])
def test_segment_reduce_matches_jax_pallas(name):
    rows, gid, n = _case(name, np.random.default_rng(11))
    bounds = np.searchsorted(gid, np.arange(n + 1), side="left").astype(np.int32)
    runs = np.diff(bounds)
    assert runs.max() <= (3 if name == "short_runs" else 1500)
    if name == "long_run":
        assert runs.max() > 32  # above kLongRun of csrc/segment_reduce.cu: the warp path
    got = segment_reduce.segment_reduce(torch.from_numpy(rows), torch.from_numpy(gid),
                                        torch.from_numpy(bounds)).numpy()
    want = _jax_reduce(rows, gid, n)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    empty = runs == 0
    assert not got[:, empty].any()
