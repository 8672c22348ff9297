"""Segment reduce of id-keyed gradient rows: the wrappers of the CUDA kernel
``csrc/segment_reduce.cu`` (counterpart of ``_segment_reduce_kernel`` in
``tpusplat/ops/rasterize_pallas.py``, whose Pallas kernel it replaces), one
for each of its three modes:

  * :func:`segment_reduce`, the dense mode: one sum per Gaussian id (the
    gather's backward), over runs from its bounds;
  * :func:`segment_reduce_targets`, the streamed-target mode: one sum per
    entry of a target list, a sentinel target getting 0 (the sender side of
    the compact gradient exchange, ``parallel/compact_grad.py``);
  * :func:`segment_reduce_multirange`, the multi-range mode: one sum per
    local id over S id-sorted blocks, in block order (its owner side).

Each routes by device: a CPU tensor goes through its plain version
(``index_add_``, rows whose id lies outside [0, n) dropped by a select), a
CUDA tensor through the kernel (or the call raises). In every mode a row
whose id lies outside [0, n) never contributes, even when it holds NaN.
"""

from __future__ import annotations

import ctypes

import torch

from tpusplat_torch.ops import _build

# Kernel launches since the last reset, per mode (chip_smoke.py reads them).
LAUNCHES = 0
TARGETS_LAUNCHES = 0
MULTIRANGE_LAUNCHES = 0
ROWS = 9  # gradient rows the kernel sums (uv.x, uv.y, conic a/b/c, opacity, r/g/b)


def _kernel():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.function("segment_reduce", "tpusplat_segment_reduce",
                           [p, ll, p, p, i, i, p, p])


def segment_reduce_plain(rows: torch.Tensor, gid: torch.Tensor, bounds: torch.Tensor):
    """Plain version: ``index_add_`` of the rows [K, R] into [K, N] by id,
    N = ``bounds.numel() - 1``. Rows whose id lies outside [0, N) are
    dropped by a select (their values may be stale memory), never by a
    multiply. Takes sorted or unsorted rows; ``bounds`` is read only for N."""
    return _index_add(rows, gid, bounds.shape[0] - 1)


def _index_add(rows, ids, n: int):
    """[K, n]: ``index_add_`` of the rows at their ids, the rows whose id
    lies outside [0, n) dropped by a select."""
    keep = (ids >= 0) & (ids < n)
    out = torch.zeros((rows.shape[0], n), dtype=rows.dtype, device=rows.device)
    return out.index_add_(1, ids[keep].long(), rows[:, keep])


def segment_reduce(rows: torch.Tensor, gid: torch.Tensor, bounds: torch.Tensor):
    """Sum the gradient rows [K, R] (float32) of each id into ``d_table``
    [K, N] (float32, the layout of the gathered table).

    ``gid`` [R] int32 must be sorted ascending and ``bounds`` [N + 1] int32
    must hold, for each id g, the first row whose id is >= g (so
    ``[bounds[g], bounds[g+1])`` is g's run; ``torch.searchsorted`` of the
    ids). Rows with ids outside [0, N) contribute nothing. The kernel reads
    only ``bounds``, never ``gid``: it sums each run as it stands, so
    ``bounds`` that break this contract give wrong sums on the card, where
    the plain version, which keys on ``gid``, would not."""
    if rows.device.type == "cpu":
        return segment_reduce_plain(rows, gid, bounds)
    return _segment_reduce_cuda(rows, gid, bounds)


def _check_rows(what, rows):
    if rows.dtype != torch.float32 or rows.dim() != 2 or not rows.is_contiguous() \
            or rows.shape[0] != ROWS:
        raise ValueError(f"{what}: rows must be contiguous float32 [{ROWS}, R], got "
                         f"{rows.dtype} {tuple(rows.shape)}")


def _segment_reduce_cuda(rows, gid, bounds):
    global LAUNCHES
    _check_rows("segment_reduce", rows)
    n = bounds.shape[0] - 1
    for name, t, size in (("gid", gid, rows.shape[1]), ("bounds", bounds, n + 1)):
        if t.device != rows.device or t.dtype != torch.int32 or t.shape != (size,) \
                or not t.is_contiguous():
            raise ValueError(f"segment_reduce: {name} must be contiguous int32 [{size}] on "
                             f"{rows.device}")
    if n >= 2**31 - 1:
        raise ValueError(f"segment_reduce: the kernel takes < 2^31 - 1 ids, got {n}")
    out = _reduce_ranges(rows, bounds[:-1][None], bounds[1:][None], 1, n)
    LAUNCHES += 1
    return out


def segment_reduce_targets_plain(rows: torch.Tensor, gid: torch.Tensor,
                                 targets: torch.Tensor, n: int):
    """Plain version of the streamed-target mode: the per-id sums of
    :func:`segment_reduce_plain` (``index_add_`` into [K, n]), read at the
    target positions, 0 where a target lies outside [0, n)."""
    dense = _index_add(rows, gid, n)
    valid = (targets >= 0) & (targets < n)
    picked = dense.index_select(1, torch.where(valid, targets, 0).long())
    return torch.where(valid[None, :], picked, 0.0)


def target_runs(gid: torch.Tensor, targets: torch.Tensor, n: int):
    """The runs the streamed-target mode sums: ([1, M], [1, M]) int32 row
    bounds of each target's id in the sorted ``gid``, by left
    ``searchsorted`` at the target and at the target + 1; empty for a
    target outside [0, n), whose run would otherwise span the sentinel
    rows."""
    lo = torch.searchsorted(gid, targets, out_int32=True)
    hi = torch.searchsorted(gid, targets + 1, out_int32=True)
    hi = torch.where((targets >= 0) & (targets < n), hi, lo)
    return lo[None], hi[None]


def segment_reduce_targets(rows: torch.Tensor, gid: torch.Tensor, targets: torch.Tensor,
                           n: int):
    """Sum the gradient rows [K, R] (float32) of each target's id into
    [K, M] (float32): column j is the sum of the rows whose id equals
    ``targets[j]`` ([M] int32), 0 for a target outside [0, n) (the sentinel
    n pads the owner blocks of the compact exchange). ``gid`` [R] int32
    must be sorted ascending; the kernel sums the runs of
    :func:`target_runs`."""
    if rows.device.type == "cpu":
        return segment_reduce_targets_plain(rows, gid, targets, n)
    global TARGETS_LAUNCHES
    _check_ids("segment_reduce_targets", rows, n, gid=gid, targets=targets)
    if gid.shape[0] != rows.shape[1]:
        raise ValueError(f"segment_reduce_targets: {rows.shape[1]} rows, {gid.shape[0]} ids")
    out = _reduce_ranges(rows, *target_runs(gid, targets, n), 1, targets.shape[0])
    TARGETS_LAUNCHES += 1
    return out


def segment_reduce_multirange_plain(rows: torch.Tensor, ids: torch.Tensor, n: int):
    """Plain version of the multi-range mode: ``index_add_`` of the rows
    [K, R] into [K, n] at their ids, the rows with ids outside [0, n)
    dropped by a select (the block layout does not matter here)."""
    return _index_add(rows, ids, n)


def multirange_runs(ids: torch.Tensor, n: int, blocks: int):
    """The runs the multi-range mode sums: ([S, n], [S, n]) int32 row bounds
    of each local id in each of the S = ``blocks`` sorted blocks of
    ``ids``, by left ``searchsorted`` at the id and at the id + 1, offset
    by the block's first row. The sentinel n and anything above it lie
    past every run."""
    if blocks < 1 or ids.shape[0] % blocks:
        raise ValueError(f"multirange_runs: {ids.shape[0]} ids do not split into "
                         f"{blocks} blocks")
    length = ids.shape[0] // blocks
    q = torch.arange(n + 1, dtype=ids.dtype, device=ids.device).expand(blocks, n + 1)
    bounds = torch.searchsorted(ids.view(blocks, length), q.contiguous(), out_int32=True)
    bounds += torch.arange(blocks, dtype=torch.int32, device=ids.device)[:, None] * length
    return bounds[:, :-1].contiguous(), bounds[:, 1:].contiguous()


def segment_reduce_multirange(rows: torch.Tensor, ids: torch.Tensor, n: int, blocks: int):
    """Sum the gradient rows [K, S * L] (float32) into [K, n] by id, where
    ``ids`` [S * L] int32 holds S = ``blocks`` blocks of L ids, each sorted
    ascending (the S all-to-all blocks an owner receives, local ids, the
    sentinel n past each block's entries). Each output adds its runs
    (:func:`multirange_runs`) in block order. Rows with ids outside [0, n)
    contribute nothing."""
    if rows.device.type == "cpu":
        return segment_reduce_multirange_plain(rows, ids, n)
    global MULTIRANGE_LAUNCHES
    _check_ids("segment_reduce_multirange", rows, n, ids=ids)
    if ids.shape[0] != rows.shape[1]:
        raise ValueError(f"segment_reduce_multirange: {rows.shape[1]} rows, {ids.shape[0]} ids")
    out = _reduce_ranges(rows, *multirange_runs(ids, n, blocks), blocks, n)
    MULTIRANGE_LAUNCHES += 1
    return out


def _check_ids(what, rows, n, **ids):
    _check_rows(what, rows)
    for name, t in ids.items():
        if t.device != rows.device or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int32 [*] on {rows.device}")
    if not 0 <= n < 2**31 - 1:
        raise ValueError(f"{what}: n = {n} out of range")


def _reduce_ranges(rows, lo, hi, rps: int, m: int):
    """Launch the kernel: out[:, j] = sum over b < rps of rows[:, lo[b,
    j]:hi[b, j]] ([rps, m] int32 each, row offsets into ``rows``; each
    [rps, m] block contiguous in memory). Counts no launch: the mode
    wrappers do."""
    out = torch.empty((ROWS, m), dtype=torch.float32, device=rows.device)
    if m == 0:
        return out
    if lo.shape != (rps, m) or hi.shape != (rps, m):
        raise ValueError(f"segment reduce ranges: lo and hi must be [{rps}, {m}]")
    if not (lo.is_contiguous() and hi.is_contiguous()):
        raise ValueError("segment reduce ranges: lo and hi must be contiguous")
    err = _kernel()(rows.data_ptr(), rows.stride(0), lo.data_ptr(), hi.data_ptr(), rps, m,
                    out.data_ptr(), _build.stream_ptr(rows.device))
    _build.check(err, "segment reduce kernel")
    return out
