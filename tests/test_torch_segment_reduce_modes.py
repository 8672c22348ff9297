"""The streamed-target and multi-range modes of the port's segment reduce
against the JAX package's Pallas kernel in those modes
(``rasterize_pallas._run_segment_reduce_general`` in interpret mode, on
``tests/test_compact_grad.py``'s inputs and seeds, and called as the JAX
``parallel/compact_grad.py`` calls it on the exchange's shapes), against
numpy sums, and on adversarial ids: sentinel targets and sentinel rows
holding NaN, empty runs, one long run, a block wholly of sentinels, warps
straddling a block boundary, ids repeated across every block, the last id
n - 1.

On the CPU each mode runs its plain version (``index_add_``). The CUDA
kernels find their runs on the card from the sorted ids; a numpy model of
that search (``_targets_model``, ``_multirange_model``: the warp's span
found by the lane groups' P-way search, each lane's run by a binary search
inside it) is held here to the runs of ``target_runs`` and
``multirange_runs``, which ``_reduce_runs``, a plain version of what the
kernel sums over runs, turns into the sums. The kernels themselves are
held to those runs, bit for bit, by chip_smoke.py.

Tolerance: atol 1e-4, the sums taking their float32 adds in different
orders (the JAX kernel sums by 0/1 matrix products)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.ops import rasterize_pallas as rp
from tpusplat.ops.binning import searchsorted_left
from tpusplat_torch.ops import segment_reduce as sr

torch.set_num_threads(2)


def _reduce_runs(rows: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """What the kernel computes from explicit runs: [K, m], column j the sum
    of ``rows[:, lo[b, j]:hi[b, j]]`` over b (``lo``, ``hi``: [rps, m])."""
    m = lo.shape[1]
    lens = (hi - lo).flatten().long()
    owner = torch.arange(m).repeat(lo.shape[0])
    first = torch.cumsum(lens, 0) - lens
    at = torch.arange(int(lens.sum())) - torch.repeat_interleave(first, lens)
    idx = torch.repeat_interleave(lo.flatten().long(), lens) + at
    out = torch.zeros((rows.shape[0], m), dtype=rows.dtype)
    return out.index_add_(1, torch.repeat_interleave(owner, lens), rows[:, idx])


def _streamed_inputs():
    """tests/test_compact_grad.py::test_segment_reduce_streamed_targets_vs_numpy."""
    rng = np.random.default_rng(1)
    n, c = 5000, 4096
    gid = np.sort(rng.integers(0, n, c)).astype(np.int32)
    grad = rng.normal(size=(16, c)).astype(np.float32)
    n_pad = 2048
    tvals = np.unique(rng.integers(0, n, n_pad // 2)).astype(np.int32)
    targets = np.full(n_pad, n, np.int32)
    targets[: len(tvals)] = tvals
    return grad, gid, targets, n


def _multirange_inputs():
    """tests/test_compact_grad.py::test_segment_reduce_multirange_vs_numpy."""
    rng = np.random.default_rng(2)
    n_local, s, cap = 2048, 4, 1024
    blocks_id, blocks_g = [], []
    for _ in range(s):
        k = int(rng.integers(cap // 2, cap))
        ids = np.sort(rng.integers(0, n_local, k)).astype(np.int32)
        blocks_id.append(np.concatenate([ids, np.full(cap - k, n_local, np.int32)]))
        blocks_g.append(rng.normal(size=(16, cap)).astype(np.float32))
    return np.stack(blocks_g, axis=1), np.stack(blocks_id), n_local


def test_streamed_targets_match_jax_pallas():
    grad, gid, targets, n = _streamed_inputs()
    n_pad = targets.shape[0]
    tseg = targets.reshape(-1, rp.GB)
    gid_j = jnp.asarray(gid)
    lo = searchsorted_left(gid_j, jnp.asarray(tseg.min(axis=1)))
    hi = searchsorted_left(gid_j, jnp.asarray(np.where(tseg < n, tseg, -1).max(axis=1)) + 1)
    win = 256
    want = jax.jit(lambda g, i, lo, hi, t: rp._run_segment_reduce_general(
        g, i, lo, hi, n_pad, n, win, rps=1, targets=t))(
        jnp.pad(jnp.asarray(grad), ((0, 0), (0, win))),
        jnp.pad(gid_j[None, :], ((0, 0), (0, win)), constant_values=-1), lo, hi,
        jnp.asarray(targets)[None, :])
    rows, tgid, ttargets = (torch.from_numpy(np.ascontiguousarray(a))
                            for a in (grad[:9], gid, targets))
    got = sr.segment_reduce_targets(rows, tgid, ttargets, n)
    assert (targets == n).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:9], atol=1e-4)
    runs = _reduce_runs(rows, *sr.target_runs(tgid, ttargets, n))
    np.testing.assert_allclose(runs.numpy(), got.numpy(), atol=1e-4)


def test_multirange_matches_jax_pallas():
    g, lid, n_local = _multirange_inputs()
    s, cap = lid.shape
    win = 128
    capw = cap + win
    g_flat = np.pad(g, ((0, 0), (0, 0), (0, win))).reshape(16, s * capw)
    lid_flat = np.pad(lid, ((0, 0), (0, win)), constant_values=n_local).reshape(1, s * capw)
    nseg = n_local // rp.GB
    qs = jnp.minimum(jnp.arange(nseg + 1, dtype=jnp.int32) * rp.GB, n_local)
    bounds = jax.vmap(lambda a: searchsorted_left(a, qs))(jnp.asarray(lid))
    base = (jnp.arange(s, dtype=jnp.int32) * capw)[:, None]
    lo = (bounds[:, :-1] + base).transpose(1, 0).reshape(-1)
    hi = (bounds[:, 1:] + base).transpose(1, 0).reshape(-1)
    want = jax.jit(lambda g, i, lo, hi: rp._run_segment_reduce_general(
        g, i, lo, hi, n_local, n_local, win, rps=s))(
        jnp.asarray(g_flat), jnp.asarray(lid_flat), lo, hi)
    rows = torch.from_numpy(np.ascontiguousarray(g[:9].reshape(9, s * cap)))
    ids = torch.from_numpy(lid.reshape(-1).copy())
    got = sr.segment_reduce_multirange(rows, ids, n_local, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:9], atol=1e-4)
    runs = _reduce_runs(rows, *sr.multirange_runs(ids, n_local, s))
    np.testing.assert_allclose(runs.numpy(), got.numpy(), atol=1e-4)


def _adversarial(kind, rng):
    """(rows [9, R], sorted ids [R], n): the sentinel n at the end, its rows
    NaN; a third of the ids without rows; for "long_run" one id with 3000
    rows (the kernel's warp-wide path)."""
    n = 600
    counts = rng.integers(0, 5, n)
    counts[rng.random(n) < 1 / 3] = 0
    if kind == "long_run":
        counts[123] = 3000
    ids = np.concatenate([np.repeat(np.arange(n), counts), np.full(200, n)]).astype(np.int32)
    rows = rng.normal(size=(9, ids.shape[0])).astype(np.float32)
    rows[:, ids == n] = np.nan
    return rows, ids, n


def _numpy_sums(rows, ids, n):
    out = np.zeros((9, n), np.float64)
    for j in range(n):
        out[:, j] = rows[:, ids == j].astype(np.float64).sum(axis=1)
    return out


@pytest.mark.parametrize("kind", ["short_runs", "long_run"])
def test_streamed_targets_adversarial(kind):
    rng = np.random.default_rng(7)
    rows, ids, n = _adversarial(kind, rng)
    want = _numpy_sums(rows, ids, n)
    # Every id once, shuffled, with sentinel and out-of-range targets among them.
    targets = np.concatenate([rng.permutation(n), np.full(50, n), [-1, n + 5]]).astype(np.int32)
    targets = rng.permutation(targets).astype(np.int32)
    t_rows, t_ids, t_targets = (torch.from_numpy(a) for a in (rows, ids, targets))
    got = sr.segment_reduce_targets(t_rows, t_ids, t_targets, n).numpy()
    runs = _reduce_runs(t_rows, *sr.target_runs(t_ids, t_targets, n)).numpy()
    valid = (targets >= 0) & (targets < n)
    for out in (got, runs):
        assert np.isfinite(out).all()
        assert not out[:, ~valid].any()  # sentinel targets: 0, never the NaN rows
        np.testing.assert_allclose(out[:, valid], want[:, targets[valid]], atol=1e-4)
    lo, hi = sr.target_runs(t_ids, t_targets, n)
    assert ((hi - lo)[0][~torch.from_numpy(valid)] == 0).all()


@pytest.mark.parametrize("kind", ["short_runs", "long_run"])
def test_multirange_adversarial(kind):
    """Three blocks of one length, each sorted with sentinel NaN rows at its
    end; every output adds its runs of the three blocks."""
    rng = np.random.default_rng(8)
    parts = [_adversarial(kind if b == 1 else "short_runs", rng) for b in range(3)]
    n = parts[0][2]
    length = max(p[1].shape[0] for p in parts)
    rows = np.full((9, 3, length), np.nan, np.float32)
    ids = np.full((3, length), n, np.int32)
    for b, (r, i, _) in enumerate(parts):
        rows[:, b, :i.shape[0]] = r
        ids[b, :i.shape[0]] = i
    rows = rows.reshape(9, -1)
    ids = ids.reshape(-1)
    want = _numpy_sums(rows, ids, n)
    t_rows, t_ids = torch.from_numpy(rows), torch.from_numpy(ids)
    got = sr.segment_reduce_multirange(t_rows, t_ids, n, 3).numpy()
    runs = _reduce_runs(t_rows, *sr.multirange_runs(t_ids, n, 3)).numpy()
    for out in (got, runs):
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, want, atol=1e-4)
    empty = want == 0
    assert empty.any() and not got[empty].any()


def test_multirange_rejects_ragged_blocks():
    with pytest.raises(ValueError):
        sr.multirange_runs(torch.zeros(10, dtype=torch.int32), 4, 3)


def test_modes_use_plain_versions_on_cpu():
    rows, ids, n = _adversarial("short_runs", np.random.default_rng(9))
    t_rows, t_ids = torch.from_numpy(rows), torch.from_numpy(ids)
    before = (sr.TARGETS_LAUNCHES, sr.MULTIRANGE_LAUNCHES)
    sr.segment_reduce_targets(t_rows, t_ids, torch.arange(n, dtype=torch.int32), n)
    sr.segment_reduce_multirange(t_rows, t_ids, n, 1)
    assert (sr.TARGETS_LAUNCHES, sr.MULTIRANGE_LAUNCHES) == before


# The exchange's shapes, cut small. Streamed-target: S_T owner blocks of
# CAP_T targets (600 = 18.75 warps, so warps straddle block boundaries)
# over R_T gid-sorted rows of N_T Gaussians. Multi-range: S_M received
# blocks of CAP_M local ids (not a multiple of 32), N_M outputs (the last
# warp partial). Each mode's cases share their shapes, so that the JAX
# reduce compiles once.
N_T, S_T, CAP_T, R_T = 3000, 3, 600, 6000
N_M, S_M, CAP_M = 2000, 4, 1000
CASES = ("bucketed", "sentinel_block", "repeated", "last_id", "all_sentinel")


@functools.partial(jax.jit, static_argnames=("n",))
def _jax_targets(rows, gid, targets, n):
    """The JAX package's streamed-target call (``compact_grad.py:228-247``):
    per-GB-segment row ranges [least target, largest live target + 1) and
    the Pallas reduce, on rows [9, R], sorted gid [R], targets [M] (M a
    multiple of GB * SEGG) -> [9, M]."""
    tseg = targets.reshape(-1, rp.GB)
    lo = searchsorted_left(gid, tseg.min(axis=1))
    hi = searchsorted_left(gid, jnp.where(tseg < n, tseg, -1).max(axis=1) + 1)
    win = 256
    grad = jnp.pad(rows, ((0, rp.GPAD - 9), (0, win)))
    gid2d = jnp.pad(gid[None, :], ((0, 0), (0, win)), constant_values=-1)
    return rp._run_segment_reduce_general(grad, gid2d, lo, hi, targets.shape[0], n, win, rps=1,
                                          targets=targets[None, :])[:9]


@functools.partial(jax.jit, static_argnames=("n_local",))
def _jax_multirange(rows, lid, n_local):
    """The JAX package's owner-side call (``compact_grad.py:266-290``) on
    rows [9, S, cap] and local ids [S, cap] -> [9, n_local]."""
    s, cap = lid.shape
    win = 256
    capw = cap + win
    g_flat = jnp.pad(rows, ((0, rp.GPAD - 9), (0, 0), (0, win))).reshape(rp.GPAD, s * capw)
    lid_flat = jnp.pad(lid, ((0, 0), (0, win)), constant_values=n_local).reshape(1, s * capw)
    unit = rp.GB * rp.SEGG
    n_pad = -(-n_local // unit) * unit
    qs = jnp.minimum(jnp.arange(n_pad // rp.GB + 1, dtype=jnp.int32) * rp.GB, n_local)
    bounds = jax.vmap(lambda a: searchsorted_left(a, qs))(lid)
    base = (jnp.arange(s, dtype=jnp.int32) * capw)[:, None]
    lo = (bounds[:, :-1] + base).T.reshape(-1)
    hi = (bounds[:, 1:] + base).T.reshape(-1)
    return rp._run_segment_reduce_general(g_flat, lid_flat, lo, hi, n_pad, n_local, win,
                                          rps=s)[:9, :n_local]


def _sums(rows, ids, n):
    """[9, n] float64: the rows of each id in [0, n), by numpy."""
    keep = (ids >= 0) & (ids < n)
    out = np.zeros((9, n), np.float64)
    np.add.at(out.T, ids[keep], rows[:, keep].T.astype(np.float64))
    return out


def _stream_case(kind, rng):
    """(rows [9, R_T] float32, sorted gid [R_T], targets [S_T * CAP_T], n).
    The targets are built as ``bucket_targets`` builds them: the stream's
    ids (each Gaussian with rows, and a few without) sorted and cut into S_T
    owner blocks, each padded with the sentinel n. The gid tail is the
    sentinel n, its rows NaN."""
    n, per = N_T, N_T // S_T
    counts = rng.integers(1, 5, n)
    counts[rng.random(n) < 0.5] = 0
    stream = (counts > 0) | (rng.random(n) < 0.05)
    if kind == "sentinel_block":  # owner 1 has no Gaussian in the strip
        counts[per:2 * per] = 0
        stream[per:2 * per] = False
    elif kind == "repeated":  # one long run (the warp-wide path)
        counts[1234] = 100
        stream[1234] = True
    elif kind == "last_id":
        counts[n - 1], stream[n - 1] = 3, True
    gid = np.repeat(np.arange(n, dtype=np.int32), counts)
    assert gid.shape[0] <= R_T - 100
    gid = np.concatenate([gid, np.full(R_T - gid.shape[0], n, np.int32)])
    rows = rng.normal(size=(9, R_T)).astype(np.float32)
    rows[:, gid == n] = np.nan
    targets = np.full((S_T, CAP_T), n, np.int32)
    for k in range(S_T):
        ids = np.flatnonzero(stream[k * per:(k + 1) * per]) + k * per
        if kind == "repeated":  # every block holds owner 0's ids
            ids = np.flatnonzero(stream[:per])
        assert ids.shape[0] <= CAP_T
        targets[k, :ids.shape[0]] = ids
    if kind == "all_sentinel":
        targets[:] = n
    if kind == "last_id":
        assert n - 1 in targets[-1]
    return rows, gid, targets.reshape(-1), n


def _multirange_case(kind, rng):
    """(rows [9, S_M * CAP_M] float32, local ids [S_M * CAP_M], n): S_M
    blocks, each sorted with the sentinel n at its tail (rows NaN there).
    Ids are unique within a block (as the exchange's are), except in the
    "repeated" case: one id in every block, and a run of 100 rows of one
    id in block 1."""
    n = N_M
    lid = np.full((S_M, CAP_M), n, np.int32)
    for b in range(S_M):
        k = int(rng.integers(CAP_M // 3, CAP_M - 50))
        ids = np.sort(rng.choice(n, k, replace=False)).astype(np.int32)
        if kind == "repeated":
            ids = np.sort(np.concatenate([ids[:k - 101], [777], np.full(100 * (b == 1), 1234)]))
        elif kind == "last_id":
            ids = np.unique(np.concatenate([ids[:-1], [n - 1]]))
        lid[b, :ids.shape[0]] = ids
    if kind == "sentinel_block":
        lid[2] = n
    elif kind == "all_sentinel":
        lid[:] = n
    rows = rng.normal(size=(9, S_M, CAP_M)).astype(np.float32)
    rows[:, lid == n] = np.nan
    return rows, lid, n


def _lower_bound(a, lo, hi, key):
    """csrc/segment_reduce.cu::lower_bound."""
    while lo < hi:
        mid = lo + (hi - lo) // 2
        lo, hi = (mid + 1, hi) if a[mid] < key else (lo, mid)
    return lo


def _group_lower_bound(a, lo, hi, key, p):
    """csrc/segment_reduce.cu::group_lower_bound for one group of p lanes:
    p probes a step, one vote."""
    while lo < hi:
        probes = [lo + (q + 1) * (hi - lo) // (p + 1) for q in range(p)]
        c = sum(int(a[x] < key) for x in probes)
        lo, hi = (probes[c - 1] + 1 if c > 0 else lo), (probes[c] if c < p else hi)
    return lo


def _targets_model(gid, targets, n):
    """The runs ([M], [M]) the streamed-target kernel finds: a warp's span
    from its least and largest live target by two groups of 16 lanes, each
    live lane's run by a binary search inside it; (0, 0) elsewhere."""
    lo, hi = np.zeros(targets.shape[0], np.int64), np.zeros(targets.shape[0], np.int64)
    for w0 in range(0, targets.shape[0], 32):
        t = targets[w0:w0 + 32]
        live = (t >= 0) & (t < n)
        if not live.any():
            continue
        s0 = _group_lower_bound(gid, 0, gid.shape[0], int(t[live].min()), 16)
        s1 = _group_lower_bound(gid, 0, gid.shape[0], int(t[live].max()) + 1, 16)
        for i in np.flatnonzero(live):
            lo[w0 + i] = _lower_bound(gid, s0, s1, t[i])
            hi[w0 + i] = _lower_bound(gid, lo[w0 + i], s1, t[i] + 1)
    return lo, hi


def _multirange_model(ids, n, blocks):
    """The runs ([S, n], [S, n]) the multi-range kernel finds: per warp
    and block, the span [lower bound of j0, lower bound of min(j0 + 32,
    n)) by its groups of four lanes, each lane's run by a binary search
    inside it; (0, 0) where the span is empty."""
    length = ids.shape[0] // blocks
    lo, hi = np.zeros((blocks, n), np.int64), np.zeros((blocks, n), np.int64)
    for j0 in range(0, n, 32):
        end = min(j0 + 32, n)
        for b in range(blocks):
            s0 = _group_lower_bound(ids, b * length, (b + 1) * length, j0, 4)
            s1 = _group_lower_bound(ids, b * length, (b + 1) * length, end, 4)
            if s0 == s1:
                continue
            for j in range(j0, end):
                lo[b, j] = _lower_bound(ids, s0, s1, j)
                hi[b, j] = _lower_bound(ids, lo[b, j], s1, j + 1)
    return lo, hi


def _assert_same_runs(lo, hi, want_lo, want_hi):
    """Both sides sum the same rows in the same order: equal runs where
    they hold rows, both empty elsewhere."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    want_lo, want_hi = (np.asarray(a, np.int64) for a in (want_lo, want_hi))
    np.testing.assert_array_equal(hi - lo, want_hi - want_lo)
    full = hi > lo
    np.testing.assert_array_equal(lo[full], want_lo[full])


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
def test_group_search_matches_searchsorted(p):
    rng = np.random.default_rng(30 + p)
    a = np.sort(rng.integers(-3, 500, 1000)).astype(np.int32)
    for key in [-5, -3, 0, 1, 250, 499, 500, 501, *rng.integers(-3, 501, 40)]:
        for lo, hi in [(0, 1000), (0, 0), (17, 18), (100, 613), (999, 1000)]:
            assert _group_lower_bound(a, lo, hi, key, p) == \
                lo + int(np.searchsorted(a[lo:hi], key, side="left"))


@pytest.mark.parametrize("kind", CASES)
def test_streamed_targets_cases_match_jax_and_numpy(kind):
    rows, gid, targets, n = _stream_case(kind, np.random.default_rng(40 + CASES.index(kind)))
    valid = (targets >= 0) & (targets < n)
    want = np.where(valid[None, :], _sums(rows, gid, n)[:, np.minimum(targets, n - 1)], 0.0)
    got = sr.segment_reduce_targets(*(torch.from_numpy(a) for a in (rows, gid, targets)), n)
    m_pad = -(-targets.shape[0] // (rp.GB * rp.SEGG)) * (rp.GB * rp.SEGG)
    jax_out = _jax_targets(jnp.asarray(rows), jnp.asarray(gid),
                           jnp.asarray(np.pad(targets, (0, m_pad - targets.shape[0]),
                                              constant_values=n)), n)
    for out in (got.numpy(), np.asarray(jax_out)[:, :targets.shape[0]]):
        assert np.isfinite(out).all()
        assert not out[:, ~valid].any()  # sentinel targets: 0, never the NaN rows
        np.testing.assert_allclose(out, want, atol=1e-4)


@pytest.mark.parametrize("kind", CASES)
def test_streamed_kernel_finds_the_target_runs(kind):
    rows, gid, targets, n = _stream_case(kind, np.random.default_rng(40 + CASES.index(kind)))
    lo, hi = _targets_model(gid, targets, n)
    want_lo, want_hi = sr.target_runs(torch.from_numpy(gid), torch.from_numpy(targets), n)
    _assert_same_runs(lo, hi, want_lo[0], want_hi[0])
    got = _reduce_runs(torch.from_numpy(rows), torch.from_numpy(lo[None]),
                       torch.from_numpy(hi[None])).numpy()
    valid = (targets >= 0) & (targets < n)
    assert np.isfinite(got).all() and not got[:, ~valid].any()
    np.testing.assert_allclose(got[:, valid], _sums(rows, gid, n)[:, targets[valid]], atol=1e-4)


@pytest.mark.parametrize("kind", CASES)
def test_multirange_cases_match_jax_and_numpy(kind):
    rows, lid, n = _multirange_case(kind, np.random.default_rng(50 + CASES.index(kind)))
    ids = lid.reshape(-1)
    flat = np.ascontiguousarray(rows.reshape(9, -1))
    want = _sums(flat, ids, n)
    got = sr.segment_reduce_multirange(torch.from_numpy(flat), torch.from_numpy(ids), n, S_M)
    jax_out = _jax_multirange(jnp.asarray(rows), jnp.asarray(lid), n)
    for out in (got.numpy(), np.asarray(jax_out)):
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, want, atol=1e-4)
    if kind == "all_sentinel":
        assert not got.numpy().any()


@pytest.mark.parametrize("kind", CASES)
def test_multirange_kernel_finds_the_runs(kind):
    rows, lid, n = _multirange_case(kind, np.random.default_rng(50 + CASES.index(kind)))
    ids = lid.reshape(-1)
    flat = np.ascontiguousarray(rows.reshape(9, -1))
    lo, hi = _multirange_model(ids, n, S_M)
    want_lo, want_hi = sr.multirange_runs(torch.from_numpy(ids), n, S_M)
    _assert_same_runs(lo, hi, want_lo, want_hi)
    got = _reduce_runs(torch.from_numpy(flat), torch.from_numpy(lo), torch.from_numpy(hi))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), _sums(flat, ids, n), atol=1e-4)
