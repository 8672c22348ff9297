"""Per-Gaussian segment reduce of id-keyed gradient rows: the wrapper of the
CUDA kernel ``csrc/segment_reduce.cu`` (counterpart of the dense mode of
``_segment_reduce_kernel`` in ``tpusplat/ops/rasterize_pallas.py``, whose
Pallas kernel it replaces).

:func:`segment_reduce` routes by device: a CPU tensor goes through the
plain version :func:`segment_reduce_plain` (``index_add_``), a CUDA tensor
through the kernel (or the call raises). The streamed-target and
multi-range modes of the JAX kernel (``parallel/compact_grad.py``) are not
ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from tpusplat_torch.ops import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)
ROWS = 9  # gradient rows the kernel sums (uv.x, uv.y, conic a/b/c, opacity, r/g/b)


def _kernel():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.function("segment_reduce", "tpusplat_segment_reduce",
                           [p, ll, p, i, p, p])


def segment_reduce_plain(rows: torch.Tensor, gid: torch.Tensor, bounds: torch.Tensor):
    """Plain version: ``index_add_`` of the rows [K, R] into [K, N] by id,
    N = ``bounds.numel() - 1``. Rows whose id lies outside [0, N) are
    dropped by a select (their values may be stale memory), never by a
    multiply. Takes sorted or unsorted rows; ``bounds`` is read only for N."""
    n = bounds.shape[0] - 1
    keep = (gid >= 0) & (gid < n)
    out = torch.zeros((rows.shape[0], n), dtype=rows.dtype, device=rows.device)
    return out.index_add_(1, gid[keep].long(), rows[:, keep])


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


def _segment_reduce_cuda(rows, gid, bounds):
    global LAUNCHES
    k, r = rows.shape
    n = bounds.shape[0] - 1
    if rows.dtype != torch.float32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"segment_reduce: rows must be contiguous float32 [K, R], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    for name, t, size in (("gid", gid, r), ("bounds", bounds, n + 1)):
        if t.device != rows.device or t.dtype != torch.int32 or t.shape != (size,) \
                or not t.is_contiguous():
            raise ValueError(f"segment_reduce: {name} must be contiguous int32 [{size}] on "
                             f"{rows.device}")
    if k != ROWS or n >= 2**31 - 1:
        raise ValueError(f"segment_reduce: the kernel takes {ROWS} rows and < 2^31 - 1 ids, "
                         f"got {k} rows, {n} ids")
    out = torch.empty((k, n), dtype=torch.float32, device=rows.device)
    if n == 0:
        return out
    err = _kernel()(rows.data_ptr(), rows.stride(0), bounds.data_ptr(), n, out.data_ptr(),
                    _build.stream_ptr(rows.device))
    _build.check(err, "segment reduce kernel")
    LAUNCHES += 1
    return out
