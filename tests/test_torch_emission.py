"""The port's emission (``tpusplat_torch.ops.binning.expand_instances_sorted``,
the plain version of ``csrc/emission.cu``) on adversarial meta: against JAX's
``expand_instances`` (XLA), against ``expand_instances_pallas`` in interpret
mode where its 8-bit packed meta allows, and against a brute force that
walks the slots one by one, bit for bit, counters included. The cases: a
third of the Gaussians culled, a run of culled Gaussians longer than a block
of the kernel, Gaussians that own more slots than a block, the capacity
ending inside a Gaussian, spare capacity, no instance, one Gaussian, a row
window (row0 != 0), a compacted stream (another sentinel id, total_true
above the total), no Gaussian and a total past INT32_MAX.

A numpy model of the CUDA kernel's algorithm (chunk scan of the counts,
merge-path tiles of Gaussians and slots found by the 32-way search, owners
found in the tile's staged window) is held to the brute force on the same
cases, at small chunk and tile sizes so that every case spans many of both:
the kernel itself runs only on the card (chip_smoke.py holds it to the plain
version there).
"""

import bisect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.ops.binning import expand_instances as jax_expand_instances
from tpusplat.ops.emission import expand_instances_pallas
from tpusplat.ops.preprocess import ProcessedGaussians
from tpusplat_torch.ops import binning, emission

torch.set_num_threads(2)

INT_MAX = 2**31 - 1
TILES_X = 48
FIELDS = ("tile", "gid", "total", "overflow", "gauss_dropped")


def _scene(kind, seed):
    """Boxes in id order and an emission order: (x0, y0, x1, y1, visible,
    order, capacity, row0, stream length). Box counts are w * h (0 where
    culled), as the JAX package derives them from the box."""
    rng = np.random.default_rng(seed)
    n = {"one_gaussian": 1}.get(kind, 3000)
    row0 = 5 if kind == "row_window" else 0
    x0 = rng.integers(0, TILES_X - 4, n)
    y0 = rng.integers(row0, row0 + 20, n)
    w = rng.integers(1, 5, n)
    h = rng.integers(1, 5, n)
    big = rng.choice(n, size=min(n, 6), replace=False)
    w[big], h[big] = 40, 30  # 1200 slots: more than a block of the kernel
    x0[big] = rng.integers(0, TILES_X - 40, len(big))
    visible = rng.random(n) >= 1 / 3
    visible[big] = True
    if kind == "no_instance":
        visible[:] = False
    order = np.argsort(rng.random(n), kind="stable")
    if n > 1000:  # a run of culled Gaussians in emission order
        visible[order[500:1100]] = False
    counts = np.where(visible, w * h, 0)
    total = int(counts.sum())
    capacity = {"spare_capacity": 2 * total + 7, "one_gaussian": 1000,
                "no_instance": 512}.get(kind, max(1, total * 9 // 10))
    stream = 2000 if kind == "compacted" else n
    return x0, y0, x0 + w, y0 + h, visible, order, capacity, row0, stream


def _meta(scene):
    """The emission meta in emission order (the kernel's inputs), numpy
    int32, and total_true (the count before the stream was cut)."""
    x0, y0, x1, y1, visible, order, _, _, stream = scene
    counts = np.where(visible, (x1 - x0) * (y1 - y0), 0)
    o = order[:stream]
    meta = [a.astype(np.int32) for a in (o, counts[o], x0[o], y0[o], y1[o] - y0[o])]
    return meta, int(counts.sum())


def _brute(ids, ntiles, x0, y0, bbh, capacity, row0, n_sentinel, total_true=None):
    """Slot by slot: each Gaussian's r-th instance is tile x0 + r // bbh +
    (y0 + r % bbh - row0) * TILES_X; the counters cast to int32 as torch
    casts int64 (modulo 2^32)."""
    tile = np.full(capacity, INT_MAX, np.int64)
    gid = np.full(capacity, n_sentinel, np.int64)
    s = 0
    for g in range(len(ids)):
        for r in range(min(int(ntiles[g]), capacity - s)):
            q, rem = divmod(r, int(bbh[g]))
            tile[s] = x0[g] + q + (y0[g] + rem - row0) * TILES_X
            gid[s] = ids[g]
            s += 1
    total = int(np.asarray(ntiles, np.int64).sum())
    dropped = 0 if total_true is None else total_true - total
    wrap = [np.array(v, np.int64).astype(np.int32) for v in
            (min(total, capacity), max(total - capacity, 0), dropped)]
    return [tile.astype(np.int32), gid.astype(np.int32), *wrap]


def _port(meta, capacity, row0, n_sentinel, total_true=None):
    t = [torch.from_numpy(a) for a in meta]
    tt = None if total_true is None else torch.tensor(total_true, dtype=torch.int64)
    return [x.numpy() for x in binning.expand_instances_sorted(
        *t, TILES_X, capacity, row0, n_sentinel, tt)]


def _assert_equal(got, want, fields=FIELDS):
    for f, a, b in zip(fields, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)


def _jax_pg(scene):
    x0, y0, x1, y1, visible, _, _, _, _ = scene
    n = len(x0)
    z = jnp.zeros((n,), jnp.float32)
    return ProcessedGaussians(
        uv=jnp.zeros((n, 2)), conic=jnp.zeros((n, 3)), opacity=z, color=jnp.zeros((n, 3)),
        depth=z, aabb=jnp.asarray(np.stack([x0, y0, x1, y1], -1), jnp.int32),
        ntiles=jnp.asarray(np.where(visible, (x1 - x0) * (y1 - y0), 0), jnp.int32),
        radius=z)


KINDS = ("mixed", "spare_capacity", "no_instance", "one_gaussian", "row_window",
         "compacted")


@pytest.mark.parametrize("kind", KINDS)
def test_plain_emission_matches_jax_xla_and_brute_force(kind):
    scene = _scene(kind, seed=KINDS.index(kind))
    meta, total_true = _meta(scene)
    n, capacity, row0 = len(scene[0]), scene[6], scene[7]
    got = _port(meta, capacity, row0, n, total_true)
    _assert_equal(got, _brute(*meta, capacity, row0, n, total_true))
    # XLA has no compacted stream: there the Gaussians past the stream are
    # culled, which emits the same instances; it reports no dropped ones.
    x0, y0, x1, y1, visible, order, _, _, stream = scene
    visible = visible.copy()
    visible[order[stream:]] = False
    ref = jax.jit(lambda pg, o: jax_expand_instances(pg, TILES_X, capacity, row0, None, o))(
        _jax_pg((x0, y0, x1, y1, visible) + scene[5:]), jnp.asarray(order, jnp.int32))
    _assert_equal(got[:4], ref[:4], FIELDS[:4])


@pytest.mark.parametrize("kind", ("mixed", "row_window", "compacted"))
def test_plain_emission_matches_pallas_interpret(kind):
    scene = _scene(kind, seed=10 + KINDS.index(kind))
    meta, total_true = _meta(scene)
    n, capacity, row0 = len(scene[0]), scene[6], scene[7]
    ids, ntiles, x0, y0, bbh = meta
    packed = x0 + (y0 << 8) + (bbh << 16)  # the Pallas kernel's 8/8/8-bit meta
    ref = expand_instances_pallas(
        _jax_pg(scene), TILES_X, capacity, row0,
        meta_sorted=(jnp.asarray(ids), jnp.asarray(ntiles), jnp.asarray(packed),
                     jnp.asarray(total_true, jnp.int32)))
    _assert_equal(_port(meta, capacity, row0, n, total_true), ref)


def _past_int32():
    rng = np.random.default_rng(7)
    n = 400
    ntiles = rng.integers(0, 4, n).astype(np.int32)
    ntiles[[3, 200, 390]] = 2**30  # total past INT32_MAX
    meta = [rng.permutation(n).astype(np.int32), ntiles,
            rng.integers(0, 40, n).astype(np.int32), rng.integers(0, 20, n).astype(np.int32),
            rng.integers(1, 9, n).astype(np.int32)]
    return meta, 5000, 0, n, int(ntiles.astype(np.int64).sum()) + 3


def _no_gaussian():
    return [np.zeros(0, np.int32)] * 5, 64, 0, 0, None


@pytest.mark.parametrize("make", (_past_int32, _no_gaussian))
def test_plain_emission_edge_cases_match_brute_force(make):
    meta, capacity, row0, n_sentinel, total_true = make()
    _assert_equal(_port(meta, capacity, row0, n_sentinel, total_true),
                  _brute(*meta, capacity, row0, n_sentinel, total_true))


def _kernel_model(ids, ntiles, x0, y0, bbh, capacity, row0, n_sentinel, items, chunk):
    """The algorithm of csrc/emission.cu in numpy, at ``items`` merge items
    a tile and ``chunk`` Gaussians a scan chunk."""
    n = len(ids)
    counts = np.asarray(ntiles, np.int64)
    # scan_kernel: offsets within each chunk (clamped), the chunks' sums.
    local = np.zeros(n, np.int64)
    sums = np.zeros(-(-n // chunk), np.int64)
    for b in range(len(sums)):
        c = counts[b * chunk:(b + 1) * chunk]
        local[b * chunk:(b + 1) * chunk] = np.minimum(np.cumsum(c) - c, INT_MAX)
        sums[b] = c.sum()
    pre = np.cumsum(sums) - sums
    total = int(sums.sum())

    def off(g):
        return min(int(pre[g // chunk] + local[g]), INT_MAX)

    def split(d):  # merge_split: the calling warp's 32 probes a step
        lo, hi = max(0, d - capacity), min(d, n)
        while hi - lo > 32:
            pos = [lo + (hi - lo) * (k + 1) // 33 for k in range(32)]
            c = sum(off(p) <= d - 1 - p for p in pos)
            lo, hi = (pos[c - 1] + 1 if c > 0 else lo), (pos[c] if c < 32 else hi)
        return lo + sum(off(p) <= d - 1 - p for p in range(lo, hi))

    tile = np.zeros(capacity, np.int64)
    gid = np.zeros(capacity, np.int64)
    seen = np.zeros(capacity, bool)
    for t in range(-(-(n + capacity) // items)):  # a block each
        d0, d1 = t * items, min((t + 1) * items, n + capacity)
        i0, i1 = split(d0), split(d1)
        g_lo = max(i0 - 1, 0)
        assert 0 <= i1 - g_lo <= items + 1
        w_off = [off(g) for g in range(g_lo, i1)]
        for s in range(d0 - i0, d1 - i1):
            assert not seen[s]
            seen[s] = True
            if s >= total:
                tile[s], gid[s] = INT_MAX, n_sentinel
                continue
            k = bisect.bisect_right(w_off, s) - 1
            assert k >= 0
            g = g_lo + k
            q, rem = divmod(s - w_off[k], int(bbh[g]))
            tile[s] = x0[g] + q + (y0[g] + rem - row0) * TILES_X
            gid[s] = ids[g]
    assert seen.all()
    return tile.astype(np.int32), gid.astype(np.int32)


@pytest.mark.parametrize("case", (*KINDS, "past_int32", "no_gaussian"))
def test_kernel_algorithm_matches_brute_force(case):
    if case == "past_int32":
        meta, capacity, row0, n_sentinel, _ = _past_int32()
    elif case == "no_gaussian":
        meta, capacity, row0, n_sentinel, _ = _no_gaussian()
    else:
        scene = _scene(case, seed=20 + KINDS.index(case))
        meta, _ = _meta(scene)
        capacity, row0, n_sentinel = scene[6], scene[7], len(scene[0])
    _assert_equal(_kernel_model(*meta, capacity, row0, n_sentinel, items=64, chunk=8),
                  _brute(*meta, capacity, row0, n_sentinel)[:2], FIELDS[:2])


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    meta, _ = _meta(_scene("mixed", seed=3))
    t = [torch.from_numpy(a) for a in meta]
    with pytest.raises(ValueError, match="no kernel"):
        emission._emit_cuda(*t, TILES_X, 100, 0, None, None)
    before = emission.LAUNCHES
    got = emission.emit_instances(*t, TILES_X, 100)
    assert emission.LAUNCHES == before  # a CPU tensor takes the plain version
    _assert_equal([x.numpy() for x in got], _brute(*meta, 100, 0, len(meta[0])))
