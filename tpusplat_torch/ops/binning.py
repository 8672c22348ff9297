"""Tile binning: depth sort, instance emission, tile sort and tile ranges
(counterpart of ``tpusplat/ops/binning.py``, full-frame and row-window
forms).

  * A stable depth sort over Gaussians, with invisible Gaussians keyed
    ``+inf``; the emission meta (tile count, x0, y0, bbh) rides it as
    payloads (``binning.py:276-309`` of the JAX package).
  * Instance emission: per slot ``s`` of a static capacity C, the owning
    Gaussian is the last one in depth order with ``off <= s`` (``off`` =
    exclusive cumsum of the tile counts), and with ``r = s - off``:
    ``tile = x0 + r // bbh + (y0 + r % bbh - row0) * tiles_x`` (x outer,
    y inner, ``preprocess_sort.comp:47-48``). Invalid slots get
    ``(INT32_MAX, N)``. On a CUDA tensor this is the hand-written kernel of
    :mod:`tpusplat_torch.ops.emission`; :func:`expand_instances_sorted` is
    its plain version, ported from the JAX ``expand_instances`` with plain
    integer division.
  * A stable sort of the slots by tile id. With the depth-major emission
    this reproduces the reference's (tile | depth) 64-bit key order.
  * Tile ranges by a left binary search per tile edge: ``end[t] ==
    start[t+1]`` and an empty tile has ``start == end``.

The ``gauss_capacity`` strip compaction and ``stream_ids`` of the JAX
package are not ported yet (``gauss_overflow`` is always 0 here).
"""

from __future__ import annotations

import dataclasses

import torch

from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops.preprocess import ProcessedGaussians

SENTINEL = 2**31 - 1  # tile id of an invalid slot


@dataclasses.dataclass
class BinnedInstances:
    """Depth-sorted (tile, gaussian) instances plus per-tile ranges."""

    gauss_id: torch.Tensor  # [C] int32 sorted payload (sentinel = N)
    tile_id: torch.Tensor  # [C] int32 sorted tile index (sentinel = INT32_MAX)
    tile_start: torch.Tensor  # [T] int32
    tile_end: torch.Tensor  # [T] int32
    num_instances: torch.Tensor  # 0-d int32 (valid, clamped to C)
    overflow: torch.Tensor  # 0-d int32: instances dropped for capacity
    gauss_overflow: torch.Tensor  # 0-d int32: always 0 (no compaction yet)


def expand_instances_sorted(ids, ntiles, x0, y0, bbh, tiles_x: int, capacity: int,
                            row0: int = 0, n_sentinel: int | None = None):
    """Plain PyTorch emission from meta already in depth-emission order.

    ``ids``, ``ntiles``, ``x0``, ``y0``, ``bbh``: [N] int32 in emission
    order. Returns ``(tile [C], gid [C], min(total, C), overflow,
    gauss_dropped)`` (int32; the last three 0-d). The plain version of the
    CUDA emission kernel, on any device.
    """
    n = ids.shape[0]
    if n_sentinel is None:
        n_sentinel = n
    dev = ids.device
    i64 = torch.int64
    cum = torch.cumsum(ntiles.to(i64), 0)  # inclusive
    total = cum[-1] if n else torch.zeros((), dtype=i64, device=dev)
    slots = torch.arange(capacity, dtype=i64, device=dev)
    valid = slots < torch.clamp_max(total, capacity)
    # Owner g[s] = #{i : cum[i] <= s}: zero-count Gaussians are skipped.
    g = torch.searchsorted(cum, slots, right=True).clamp_max(max(n - 1, 0))
    if n:
        r = slots - (cum - ntiles.to(i64))[g]
        b = bbh.to(i64)[g]
        q = torch.div(r, b, rounding_mode="floor")
        rem = r - q * b
        tile = x0.to(i64)[g] + q + (y0.to(i64)[g] + rem - row0) * tiles_x
        gid = ids.to(i64)[g]
    else:
        tile = gid = slots
    tile = torch.where(valid, tile, SENTINEL).to(torch.int32)
    gid = torch.where(valid, gid, n_sentinel).to(torch.int32)
    return _counters(tile, gid, total, capacity)


def _counters(tile, gid, total, capacity: int):
    """The shared tail of both emission routes: (tile, gid, min(total, C),
    overflow, gauss_dropped) with int32 0-d counters."""
    i32 = torch.int32
    return (tile, gid, torch.clamp_max(total, capacity).to(i32),
            torch.clamp_min(total - capacity, 0).to(i32),
            torch.zeros((), dtype=i32, device=tile.device))


def _window_meta(pg: ProcessedGaussians, row0: int, nrows: int | None):
    """Per-Gaussian emission meta in id order, clipped to the tile-row
    window [row0, row0 + nrows) unless ``nrows`` is None: (x0, y0, bbh,
    ntiles) int32."""
    x0, y0, x1, y1 = (pg.aabb[:, k] for k in range(4))
    if nrows is not None:
        y0 = torch.clamp(y0, row0, row0 + nrows)
        y1 = torch.clamp(y1, row0, row0 + nrows)
    ntiles = torch.where(pg.ntiles > 0, (x1 - x0) * torch.clamp_min(y1 - y0, 0), 0)
    bbh = torch.clamp_min(y1 - y0, 1)
    return x0, y0, bbh, ntiles.to(torch.int32)


def expand_instances(pg: ProcessedGaussians, tiles_x: int, capacity: int, row0: int = 0,
                     nrows: int | None = None, depth_order: torch.Tensor | None = None):
    """Per-slot (tile_id, gauss_id) for C static slots, emitting Gaussians
    in ``depth_order`` (id order if None) — the contract of the JAX
    ``expand_instances``, in plain PyTorch."""
    n = pg.ntiles.shape[0]
    x0, y0, bbh, ntiles = _window_meta(pg, row0, nrows)
    if depth_order is None:
        ids = torch.arange(n, dtype=torch.int32, device=pg.ntiles.device)
    else:
        ids = depth_order.to(torch.int32)
    idx = ids.long()
    return expand_instances_sorted(ids, ntiles[idx], x0[idx], y0[idx], bbh[idx],
                                   tiles_x, capacity, row0, n)


def depth_sorted_meta(pg: ProcessedGaussians, row0: int = 0, nrows: int | None = None):
    """Stable depth sort over Gaussians (invisible -> +inf key) carrying the
    emission meta as payloads. Returns (ids, ntiles, x0, y0, bbh), [N]
    int32 each, in depth-emission order — the inputs of the emission
    kernel. Ordering does not differentiate (the reference's sort is
    forward-only)."""
    x0, y0, bbh, ntiles = _window_meta(pg, row0, nrows)
    key = torch.where(pg.ntiles > 0, pg.depth.detach(),
                      torch.full_like(pg.depth.detach(), float("inf")))
    order = torch.sort(key, stable=True).indices
    return (order.to(torch.int32), ntiles[order], x0[order], y0[order], bbh[order])


def bin_and_sort(
    pg: ProcessedGaussians,
    width: int,
    height: int,
    cfg: RenderConfig,
    row0: int = 0,
    nrows: int | None = None,
    capacity: int | None = None,
) -> BinnedInstances:
    """Bin instances for the full image or a window of ``nrows`` tile rows.

    Routes by device: emission runs the CUDA kernel on a CUDA tensor and
    :func:`expand_instances_sorted` on a CPU tensor."""
    from tpusplat_torch.ops.emission import emit_instances

    tiles_x, tiles_y = cfg.tile_grid(width, height)
    n = pg.ntiles.shape[0]
    if capacity is None:
        capacity = cfg.instance_capacity(n)

    ids_d, nt_d, x0_d, y0_d, bbh_d = depth_sorted_meta(pg, row0, nrows)
    num_tiles = tiles_x * (tiles_y if nrows is None else nrows)
    tile, gid, total, overflow, gauss_ovf = emit_instances(
        ids_d, nt_d, x0_d, y0_d, bbh_d, tiles_x, capacity, row0, n)
    tile_s, perm = torch.sort(tile, stable=True)
    gid_s = gid[perm]

    edges = torch.arange(num_tiles + 1, dtype=torch.int32, device=tile.device)
    bounds = torch.searchsorted(tile_s, edges, out_int32=True)
    return BinnedInstances(
        gauss_id=gid_s,
        tile_id=tile_s,
        tile_start=bounds[:num_tiles],
        tile_end=bounds[1:],
        num_instances=total,
        overflow=overflow,
        gauss_overflow=gauss_ovf,
    )
