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

Strip compaction (``gauss_capacity``, ``binning.py:238-353`` of the JAX
package): in a row window the depth key marks the Gaussians invisible in
the strip ``+inf``, so the stable depth sort itself puts the strip's
Gaussians first, in global depth order; emission then runs over the first
``gauss_capacity`` of them only, and ``stream_ids`` keeps their ids.
Instances of visible Gaussians past the cap are ``gauss_overflow``.
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
    gauss_overflow: torch.Tensor  # 0-d int32: instances dropped by the stream cap
    # Compacted stream (strip compaction only, else None): the ids of the
    # strip's first ``gauss_capacity`` Gaussians in depth order, the entries
    # past the strip's visible count set to the sentinel N.
    stream_ids: torch.Tensor | None = None


def expand_instances_sorted(ids, ntiles, x0, y0, bbh, tiles_x: int, capacity: int,
                            row0: int = 0, n_sentinel: int | None = None, total_true=None):
    """Plain PyTorch emission from meta already in depth-emission order.

    ``ids``, ``ntiles``, ``x0``, ``y0``, ``bbh``: [N] int32 in emission
    order. Returns ``(tile [C], gid [C], min(total, C), overflow,
    gauss_dropped)`` (int32; the last three 0-d). ``total_true``, where the
    meta is a compacted stream, is the instance count before compaction:
    ``gauss_dropped`` is what the stream lost (0 when not given). The plain
    version of the CUDA emission kernel, on any device.
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
    return _counters(tile, gid, total, capacity, total_true)


def _counters(tile, gid, total, capacity: int, total_true=None):
    """The shared tail of both emission routes: (tile, gid, min(total, C),
    overflow, gauss_dropped) with int32 0-d counters; gauss_dropped =
    ``total_true - total`` (``emission.py:245-247`` of the JAX package)."""
    i32 = torch.int32
    dropped = (torch.zeros((), dtype=i32, device=tile.device) if total_true is None
               else (total_true - total).to(i32))
    return (tile, gid, torch.clamp_max(total, capacity).to(i32),
            torch.clamp_min(total - capacity, 0).to(i32), dropped)


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


def strip_visible(pg: ProcessedGaussians, row0: int, nrows: int) -> torch.Tensor:
    """[N] bool: the Gaussians that cover a tile of the row window
    [row0, row0 + nrows) (the strip-clipped visibility of the JAX package)."""
    y0 = pg.aabb[:, 1].clamp(row0, row0 + nrows)
    y1 = pg.aabb[:, 3].clamp(row0, row0 + nrows)
    return (pg.ntiles > 0) & (y1 > y0)


def depth_sorted_meta(pg: ProcessedGaussians, row0: int = 0, nrows: int | None = None,
                      visible: torch.Tensor | None = None):
    """Stable depth sort over Gaussians (invisible -> +inf key) carrying the
    emission meta as payloads. Returns (ids, ntiles, x0, y0, bbh), [N]
    int32 each, in depth-emission order — the inputs of the emission
    kernel. ``visible`` ([N] bool) defaults to ``pg.ntiles > 0``; strip
    compaction passes :func:`strip_visible`. Ordering does not
    differentiate (the reference's sort is forward-only)."""
    x0, y0, bbh, ntiles = _window_meta(pg, row0, nrows)
    if visible is None:
        visible = pg.ntiles > 0
    key = torch.where(visible, pg.depth.detach(),
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
    gauss_capacity: int | None = None,
) -> BinnedInstances:
    """Bin instances for the full image or a window of ``nrows`` tile rows.

    ``gauss_capacity`` (a row window only): emit from the first
    ``gauss_capacity`` strip-visible Gaussians in depth order. The port
    compacts whenever ``gauss_capacity < N`` and the window is narrower than
    the frame; the JAX package compacts only where its Pallas emission's
    8-bit packed meta fits (``pallas_emission_ok``, a TPU limit), so the
    results equal the JAX ones with ``use_pallas=True``.

    Routes by device: emission runs the CUDA kernel on a CUDA tensor and
    :func:`expand_instances_sorted` on a CPU tensor."""
    from tpusplat_torch.ops.emission import emit_instances

    tiles_x, tiles_y = cfg.tile_grid(width, height)
    n = pg.ntiles.shape[0]
    if capacity is None:
        capacity = cfg.instance_capacity(n)
    compact = (gauss_capacity is not None and gauss_capacity < n and nrows is not None
               and nrows < tiles_y)

    visible = strip_visible(pg, row0, nrows) if compact else None
    meta = depth_sorted_meta(pg, row0, nrows, visible)
    num_tiles = tiles_x * (tiles_y if nrows is None else nrows)
    stream_ids = total_true = None
    if compact:
        total_true = meta[1].sum()
        meta = tuple(t[:gauss_capacity] for t in meta)
        slots = torch.arange(gauss_capacity, device=visible.device)
        stream_ids = torch.where(slots < visible.sum(), meta[0], n).to(torch.int32)
    tile, gid, total, overflow, gauss_ovf = emit_instances(
        *meta, tiles_x, capacity, row0, n, total_true)
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
        stream_ids=stream_ids,
    )
