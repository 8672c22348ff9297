"""Instance emission: the wrapper of the CUDA kernel ``csrc/emission.cu``
(counterpart of ``tpusplat/ops/emission.py``, whose Pallas kernel it
replaces).

:func:`emit_instances` routes by device: a CPU tensor goes through the
plain version :func:`tpusplat_torch.ops.binning.expand_instances_sorted`,
a CUDA tensor through the kernel (or the call raises). Both give the same
(tile, gid) per slot and the same counters, bit for bit. On the card one
call is two allocations and one C call, which launches the kernel's two
parts (the chunk scan of the counts, then the emission, which also writes
the three counters).
"""

from __future__ import annotations

import ctypes

import torch

from tpusplat_torch.ops import _build
from tpusplat_torch.ops.binning import expand_instances_sorted

# C calls of the kernel since the last reset (chip_smoke.py reads it); one
# call launches both of its parts.
LAUNCHES = 0

META = ("ids", "ntiles", "x0", "y0", "bbh")
# int32 words of the chunk sums (csrc/emission.cu's kMaxChunks int64), which
# share a small buffer with the three counters.
CHUNK_WORDS = 2 * 2048


def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.function("emission", "tpusplat_emit",
                           [p, p, p, p, p, i, p, i, i, i, i, p, p, p, p, p, p])


def emit_instances(ids, ntiles, x0, y0, bbh, tiles_x: int, capacity: int,
                   row0: int = 0, n_sentinel: int | None = None, total_true=None):
    """Per-slot (tile, gid) for ``capacity`` slots from the depth-ordered
    meta (``ids``, ``ntiles``, ``x0``, ``y0``, ``bbh``: [N] int32, as
    :func:`tpusplat_torch.ops.binning.depth_sorted_meta` returns them, or
    its first entries for a compacted stream). Returns ``(tile, gid,
    min(total, C), overflow, gauss_dropped)``; ``gauss_dropped`` is
    ``total_true - total`` (0 when ``total_true``, the instance count before
    compaction, a 0-d int64 tensor, is not given)."""
    if ids.device.type == "cpu":
        return expand_instances_sorted(ids, ntiles, x0, y0, bbh, tiles_x, capacity,
                                       row0, n_sentinel, total_true)
    return _emit_cuda(ids, ntiles, x0, y0, bbh, tiles_x, capacity, row0, n_sentinel,
                      total_true)


def output_buffers(n: int, capacity: int, device):
    """The kernel's two int32 buffers: the chunk sums with the 3 counters
    after them, and tile [C], gid [C] with the scan's [N] offsets after
    them. Two, so that the counters, which live as long as the binning,
    do not hold the tens of MB of the other, which the tile sort frees."""
    return (torch.empty(CHUNK_WORDS + 3, dtype=torch.int32, device=device),
            torch.empty(2 * capacity + n, dtype=torch.int32, device=device))


def launch(ids, ntiles, x0, y0, bbh, tiles_x, capacity, row0, n_sentinel, total_true, bufs):
    """One C call of the kernel into ``bufs`` (:func:`output_buffers`), on
    checked inputs, counted in ``LAUNCHES``."""
    global LAUNCHES
    small, tile = bufs[0].data_ptr(), bufs[1].data_ptr()
    err = _kernel()(
        ntiles.data_ptr(), x0.data_ptr(), y0.data_ptr(), bbh.data_ptr(), ids.data_ptr(),
        ids.shape[0], None if total_true is None else total_true.data_ptr(), capacity,
        tiles_x, row0, n_sentinel, small, tile + 8 * capacity, tile, tile + 4 * capacity,
        small + 4 * CHUNK_WORDS, _build.stream_ptr(bufs[1].device))
    _build.check(err, "emission kernel")
    LAUNCHES += 1


def _emit_cuda(ids, ntiles, x0, y0, bbh, tiles_x, capacity, row0, n_sentinel, total_true):
    n, dev = ids.shape[0], ids.device
    if dev.type != "cuda":
        raise ValueError(f"emit_instances: no kernel for tensors on {dev}")
    for name, t in zip(META, (ids, ntiles, x0, y0, bbh)):
        if t.device != dev or t.dtype != torch.int32 or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"emit_instances: {name} must be contiguous int32 [{n}] on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if total_true is not None and (total_true.device != dev or total_true.dtype != torch.int64
                                   or total_true.dim() != 0):
        raise ValueError(f"emit_instances: total_true must be a 0-d int64 on {dev}")
    if not 0 < capacity < 2**31 - 1:
        raise ValueError(f"emit_instances: capacity {capacity} out of range")
    small, big = output_buffers(n, capacity, dev)
    launch(ids, ntiles, x0, y0, bbh, tiles_x, capacity, int(row0),
           n if n_sentinel is None else n_sentinel, total_true, (small, big))
    c = CHUNK_WORDS
    return big[:capacity], big[capacity:2 * capacity], small[c], small[c + 1], small[c + 2]
