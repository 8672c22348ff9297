"""Compact gradient exchange of the tile-sharded training step (counterpart
of ``tpusplat/parallel/compact_grad.py``).

The dense exchange (``grad_exchange="dense"``) backpropagates the attribute
all-gather, whose backward reduce-scatters a dense [N, 16] gradient table:
every rank reduces gradients over all N Gaussians although its strip
touched a fraction of them. The compact exchange keeps the gradients in the
strip's compacted Gaussian stream end to end, in one autograd function
(:class:`_ExchangeRender`):

  forward, numerically the dense path's: the exchange table (cols 0-8 the
  blend's attributes, cols 9-14 the binning fields, detached) is gathered
  over ``tile``; strip binning with compaction and the forward kernel
  render the strip; the stream's ids are kept; the all-to-all bucket
  occupancy is counted here, so that a bucket overflow gates the step like
  any capacity overflow.

  backward: the backward kernel, a sort of the gradient rows by Gaussian id,
  then the segment reduce in its streamed-target mode straight into S
  owner-contiguous buckets of the sorted stream ids (sentinel-padded to a
  static capacity), one ``all_to_all_single`` of the buckets (rows and ids)
  to their owners, and the owner's segment reduce in its multi-range mode
  over the S received blocks into its dense local [N/S, 16] cotangent.

Every emitted instance's id is in the stream, each id in exactly one
bucket, and each owner adds each peer's partial once: the result equals the
dense exchange up to the order of the adds.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops.binning import bin_and_sort
from tpusplat_torch.ops.preprocess import ProcessedGaussians
from tpusplat_torch.ops.rasterize import ATTR_ROWS, backward_blend, forward_blend
from tpusplat_torch.ops.segment_reduce import segment_reduce_multirange, segment_reduce_targets
from tpusplat_torch.parallel.collectives import for_backend, gather_chunks

# Constants of the JAX package's bucket rounding (rasterize_pallas.py GB and
# SEGG): a2a_bucket_cap keeps its formula bit for bit, since the cap decides
# when a step is gated.
GB, SEGG = 256, 8


@dataclasses.dataclass(frozen=True)
class CompactStatic:
    """The static shape of one strip's compact exchange."""

    cfg: RenderConfig
    width: int
    height: int
    nrows: int
    cap_shard: int
    gcap: int
    n_total: int
    n_local: int
    n_shards: int


def pack_exchange_table(pg: ProcessedGaussians) -> torch.Tensor:
    """[N, 16] exchange table: cols 0-8 the blend's attribute layout (uv,
    conic, opacity, colour; differentiable), cols 9-14 the binning fields
    (depth, aabb, ntiles; detached, since ordering and tile assignment do
    not differentiate), col 15 pad. aabb and ntiles are small integers,
    exact in float32."""
    n = pg.uv.shape[0]
    fields = torch.cat([pg.depth[:, None], pg.aabb.to(torch.float32),
                        pg.ntiles.to(torch.float32)[:, None],
                        torch.zeros((n, 1), dtype=torch.float32, device=pg.uv.device)], dim=-1)
    return torch.cat([pg.uv, pg.conic, pg.opacity[:, None], pg.color, fields.detach()], dim=-1)


def pg_from_table(tbl: torch.Tensor) -> ProcessedGaussians:
    """The ProcessedGaussians a table row carries (radius 0: not exchanged)."""
    return ProcessedGaussians(
        uv=tbl[:, 0:2], conic=tbl[:, 2:5], opacity=tbl[:, 5], color=tbl[:, 6:9],
        depth=tbl[:, 9], aabb=tbl[:, 10:14].to(torch.int32), ntiles=tbl[:, 14].to(torch.int32),
        radius=tbl.new_zeros(tbl.shape[0]))


def a2a_bucket_cap(st: CompactStatic) -> int:
    """Static capacity of one all-to-all bucket (``compact_grad.py:120-135``
    of the JAX package, bit for bit): ``grad_a2a_mult`` times the stream's
    even split over the shards, at most N/S, rounded up so that S x cap is a
    multiple of GB x SEGG."""
    s = st.n_shards
    even = -(-st.gcap // s)
    cap = min(int(even * st.cfg.grad_a2a_mult), st.n_local)
    unit = (GB * SEGG) // math.gcd(GB * SEGG, s)
    cap = max(unit, -(-cap // unit) * unit)
    if st.n_local % unit == 0:
        cap = min(cap, st.n_local)
    return cap


def bucket_targets(stream_ids: torch.Tensor, st: CompactStatic) -> torch.Tensor:
    """[S * cap] int32: the stream's ids sorted, cut into S owner blocks of
    ``a2a_bucket_cap`` entries (owner k holds ids [k N/S, (k+1) N/S)), each
    padded with the sentinel N. Ids past a full bucket are dropped: the
    forward's ``a2a_overflow`` counts them and gates the step."""
    s, n, cap = st.n_shards, st.n_total, a2a_bucket_cap(st)
    dev = stream_ids.device
    sid = torch.sort(stream_ids).values  # the sentinels N sort last
    edges = torch.arange(s + 1, dtype=torch.int32, device=dev) * st.n_local
    bounds = torch.searchsorted(sid, edges, out_int32=True)
    sid_pad = torch.cat([sid, torch.full((cap,), n, dtype=sid.dtype, device=dev)])
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    blk = sid_pad[(bounds[:-1, None] + slot[None, :]).long()]
    count = bounds[1:] - bounds[:-1]
    return torch.where(slot[None, :] < count[:, None], blk, n).reshape(-1).to(torch.int32)


def owner_local_ids(ids_x: torch.Tensor, k0: torch.Tensor, st: CompactStatic) -> torch.Tensor:
    """[S * cap] int32 local ids of the S received blocks: block b's ids
    less its owner's first id ``k0[b]``, the sentinel N mapped to N/S."""
    s = st.n_shards
    lid = ids_x.view(s, -1) - k0.view(s, 1)
    return torch.clamp_max(lid, st.n_local).reshape(-1).to(torch.int32)


def strip_forward(tbl_full: torch.Tensor, row0: int, st: CompactStatic):
    """Render one camera's strip from the gathered table [N, 16]. Returns
    (img [nrows * tile_h, W, 3], counters [4] int32: capacity, tile, gauss
    and a2a overflow, residuals for :func:`strip_backward`)."""
    cfg = st.cfg
    tiles_x, _ = cfg.tile_grid(st.width, st.height)
    crop_h = st.nrows * cfg.tile_h
    binned = bin_and_sort(pg_from_table(tbl_full), st.width, st.height, cfg, row0, st.nrows,
                          st.cap_shard, gauss_capacity=st.gcap)
    safe = torch.clamp_max(binned.gauss_id, st.n_total - 1).long()
    attr = tbl_full[:, :ATTR_ROWS].index_select(0, safe).T.contiguous()
    img, tmap, tile_ovf = forward_blend(attr, binned.tile_start, binned.tile_end, tiles_x, row0,
                                        st.width, crop_h, cfg)

    # The all-to-all bucket occupancy depends on the stream only: the number
    # of stream ids each shard owns against the bucket capacity (the
    # sentinels N fall in no bucket).
    owner = torch.div(binned.stream_ids, st.n_local, rounding_mode="floor").long()
    count = torch.bincount(owner, minlength=st.n_shards + 1)[:st.n_shards]
    a2a_ovf = torch.clamp_min(count - a2a_bucket_cap(st), 0).sum()
    counters = torch.stack([binned.overflow, tile_ovf.to(torch.int32),
                            binned.gauss_overflow, a2a_ovf.to(torch.int32)])
    res = (attr, binned.gauss_id, binned.tile_start, binned.tile_end, img, tmap,
           binned.stream_ids)
    return img, counters, res


def sort_by_id(d_attr: torch.Tensor, gauss_id: torch.Tensor):
    """(gradient rows [9, C] sorted by Gaussian id, the sorted ids)."""
    gid_s, perm = torch.sort(gauss_id, stable=True)
    return d_attr.index_select(1, perm), gid_s


def strip_backward(res, d_img: torch.Tensor, row0: int, st: CompactStatic, group=None):
    """The compact exchange's backward for one camera's strip: [N/S, 16]
    cotangent of this rank's table shard. ``group`` is the ``tile`` group;
    None runs the single-process emulation, whose exchange is the identity
    (block b is this process's own bucket for owner b)."""
    attr, gauss_id, starts, ends, img, tmap, stream_ids = res
    cfg = st.cfg
    tiles_x, _ = cfg.tile_grid(st.width, st.height)
    s, n_local = st.n_shards, st.n_local
    d_attr = backward_blend(attr, starts, ends, img, tmap, d_img.contiguous(),
                            torch.zeros_like(tmap), tiles_x, row0, st.width, img.shape[0], cfg)
    rows, gid_s = sort_by_id(d_attr, gauss_id)
    targets = bucket_targets(stream_ids, st)
    g_red = segment_reduce_targets(rows, gid_s, targets, st.n_total)  # [9, S * cap]

    dev = g_red.device
    if group is None:
        g_x, ids_x = g_red, targets
        k0 = torch.arange(s, dtype=torch.int32, device=dev) * n_local
    else:
        g_x, ids_x = exchange_buckets(g_red, targets, s, group)
        me = dist.get_rank(group)
        k0 = torch.full((s,), me * n_local, dtype=torch.int32, device=dev)
    lid = owner_local_ids(ids_x, k0, st)
    dense = segment_reduce_multirange(g_x, lid, n_local, s)  # [9, N/S]
    d_tbl = dense.new_zeros((n_local, 16))
    d_tbl[:, :ATTR_ROWS] = dense.T
    return d_tbl


def exchange_buckets(g_red: torch.Tensor, targets: torch.Tensor, s: int, group):
    """Send bucket k (its [9, cap] rows and [cap] ids) to rank k of
    ``group``; returns the S received blocks, peer b's in block b, as
    ([9, S * cap], [S * cap])."""
    cap = targets.shape[0] // s
    rows = g_red.view(ATTR_ROWS, s, cap).permute(1, 0, 2)  # [S, 9, cap]
    dev = g_red.device
    send_r, send_i = for_backend(rows, group), for_backend(targets, group)
    recv_r, recv_i = torch.empty_like(send_r), torch.empty_like(send_i)
    dist.all_to_all_single(recv_r, send_r, group=group)
    dist.all_to_all_single(recv_i, send_i, group=group)
    g_x = recv_r.to(dev).permute(1, 0, 2).reshape(ATTR_ROWS, s * cap).contiguous()
    return g_x, recv_i.to(dev)


def _render_strips(table_full, st: CompactStatic, row0: int):
    """:func:`strip_forward` for each camera's table of [B, N, 16]:
    (strips [B, rows, W, 3], counters [B, 4] int32, residuals)."""
    imgs, counters, res = zip(*(strip_forward(tbl, row0, st) for tbl in table_full))
    return torch.stack(imgs), torch.stack(counters), res


class _ExchangeRender(torch.autograd.Function):
    """``group`` None is the one-process emulation: ``table`` is then the
    full table, the all-to-all the identity, and the cotangent is padded
    back to the full table's N rows."""

    @staticmethod
    def forward(ctx, table, st, group, row0):
        table_full = table if group is None else torch.cat(gather_chunks(table, group), dim=1)
        imgs, counters, ctx.res = _render_strips(table_full, st, row0)  # table_full [B, N, 16]
        ctx.st, ctx.group, ctx.row0 = st, group, row0
        ctx.mark_non_differentiable(counters)
        return imgs, counters

    @staticmethod
    def backward(ctx, d_imgs, _d_counters):
        st = ctx.st
        d = torch.stack([strip_backward(r, g, ctx.row0, st, ctx.group)
                         for r, g in zip(ctx.res, d_imgs)])
        if ctx.group is None:  # a zero fill the real path does not pay
            d = torch.nn.functional.pad(d, (0, 0, 0, st.n_total - st.n_local))
        return d, None, None, None


def exchange_render(table_local: torch.Tensor, st: CompactStatic, group, row0: int):
    """Gather the exchange tables [B_local, N/S, 16] over the ``tile`` group
    and render this rank's strip (first tile row ``row0``) for every local
    camera; the backward runs the compact all-to-all exchange. Returns
    (strips [B_local, nrows * tile_h, W, 3], counters [B_local, 4] int32:
    capacity, tile, gauss and a2a overflow)."""
    return _ExchangeRender.apply(table_local, st, group, row0)


def exchange_render_emulated(table_full: torch.Tensor, st: CompactStatic, row0: int):
    """One process's cost emulation of :func:`exchange_render`: the full
    table [B, N, 16] is given (no gather) and the all-to-all is the
    identity, so every stage of the compact backward (gradient sort, bucket
    build, streamed-target reduce, multi-range owner reduce) runs with the
    shapes and data of the S-shard path. Its gradient has no meaning (the
    owner reduce sums a mixture of shards' ids): it measures a strip's cost
    on one card."""
    return _ExchangeRender.apply(table_full, st, None, row0)
