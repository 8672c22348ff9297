"""The streamed-target and multi-range modes of the port's segment reduce
against the JAX package's Pallas kernel in those modes
(``rasterize_pallas._run_segment_reduce_general`` in interpret mode, on
``tests/test_compact_grad.py``'s inputs and seeds), and on adversarial ids:
sentinel targets and sentinel rows holding NaN, empty runs, one long run.

On the CPU each mode runs its plain version (``index_add_``). The runs the
CUDA wrappers hand the kernel (``target_runs``, ``multirange_runs``) are
held here through ``_reduce_runs``, a plain version of what the kernel
computes from them; the kernel itself is held to the plain versions by
chip_smoke.py.

Tolerance: atol 1e-4, the sums taking their float32 adds in different
orders (the JAX kernel sums by 0/1 matrix products)."""

import numpy as np
import pytest
import torch

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
    import jax
    import jax.numpy as jnp

    from tpusplat.ops import rasterize_pallas as rp
    from tpusplat.ops.binning import searchsorted_left

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
    import jax
    import jax.numpy as jnp

    from tpusplat.ops import rasterize_pallas as rp
    from tpusplat.ops.binning import searchsorted_left

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
