"""Instance emission: the wrapper of the CUDA kernel ``csrc/emission.cu``
(counterpart of ``tpusplat/ops/emission.py``, whose Pallas kernel it
replaces).

:func:`emit_instances` routes by device: a CPU tensor goes through the
plain version :func:`tpusplat_torch.ops.binning.expand_instances_sorted`,
a CUDA tensor through the kernel (or the call raises). Both give the same
(tile, gid) per slot, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from tpusplat_torch.ops import _build
from tpusplat_torch.ops.binning import SENTINEL, _counters, expand_instances_sorted

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.function("emission", "tpusplat_emission",
                           [p, p, p, p, p, i, p, i, i, i, i, p, p, p])


def emit_instances(ids, ntiles, x0, y0, bbh, tiles_x: int, capacity: int,
                   row0: int = 0, n_sentinel: int | None = None, total_true=None):
    """Per-slot (tile, gid) for ``capacity`` slots from the depth-ordered
    meta (``ids``, ``ntiles``, ``x0``, ``y0``, ``bbh``: [N] int32, as
    :func:`tpusplat_torch.ops.binning.depth_sorted_meta` returns them, or
    its first entries for a compacted stream). Returns ``(tile, gid,
    min(total, C), overflow, gauss_dropped)``; ``gauss_dropped`` is
    ``total_true - total`` (0 when ``total_true``, the instance count before
    compaction, is not given)."""
    if ids.device.type == "cpu":
        return expand_instances_sorted(ids, ntiles, x0, y0, bbh, tiles_x, capacity,
                                       row0, n_sentinel, total_true)
    return _emit_cuda(ids, ntiles, x0, y0, bbh, tiles_x, capacity, row0, n_sentinel,
                      total_true)


def _emit_cuda(ids, ntiles, x0, y0, bbh, tiles_x, capacity, row0, n_sentinel, total_true):
    global LAUNCHES
    n = ids.shape[0]
    for name, t in dict(ids=ids, ntiles=ntiles, x0=x0, y0=y0, bbh=bbh).items():
        if t.device != ids.device or t.device.type != "cuda":
            raise ValueError(f"emit_instances: {name} must be on {ids.device}, got {t.device}")
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"emit_instances: {name} must be contiguous int32 [{n}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not 0 < capacity < 2**31 - 1:
        raise ValueError(f"emit_instances: capacity {capacity} out of range")
    if n_sentinel is None:
        n_sentinel = n
    cum = torch.cumsum(ntiles, 0)  # int64 (torch widens int32 sums)
    total = cum[-1] if n else cum.new_zeros(())
    # Offsets past INT32_MAX only ever compare greater than every slot.
    off = (cum - ntiles).clamp_max(SENTINEL).to(torch.int32)
    tile = torch.empty(capacity, dtype=torch.int32, device=ids.device)
    gid = torch.empty_like(tile)
    err = _kernel()(
        off.data_ptr(), x0.data_ptr(), y0.data_ptr(), bbh.data_ptr(), ids.data_ptr(), n,
        total.data_ptr(), capacity, tiles_x, int(row0), n_sentinel,
        tile.data_ptr(), gid.data_ptr(), _build.stream_ptr(ids.device))
    _build.check(err, "emission kernel")
    LAUNCHES += 1
    return _counters(tile, gid, total, capacity, total_true)
