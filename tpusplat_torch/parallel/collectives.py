"""Collectives of the tile-sharded path (counterpart of
``tpusplat/parallel/collectives.py``, plus the autograd-aware exchanges that
``shard_map`` gave the JAX package for free).

  * :func:`all_gather` (backward: reduce-scatter, a sum) gathers the
    screen attributes over ``tile``: each tile rank renders a different
    strip from them, so their cotangents add up.
  * :func:`gather_strips` (backward: the rank's own slice) assembles the
    image from the strips: every rank then takes the same loss of the whole
    image, so the cotangent of its strip is just its slice. Summing it, as
    the attribute gather's backward does, would multiply the gradients by
    the number of tile ranks.
  * :func:`halo_exchange` passes the SSIM window's context rows between
    neighbouring strips, and its backward passes their cotangents back.
  * :func:`ring_all_reduce`: an all-reduce of a dict of tensors in 2(S-1)
    point-to-point steps, equal to ``all_reduce`` up to reassociation.

Every backend takes the same calls (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``batch_isend_irecv``), so the
tests' gloo groups on the CPU run the code that NCCL runs on the cards. A
gloo group reads host memory only: a tensor on the card is copied to the
host around the call and back (:func:`for_backend`). That is the path of
processes sharing one card, where NCCL cannot run two ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# Exchange-table layout of the tile-sharded render (compact_grad.py): 16
# float32 attribute columns gathered forward, 9 live gradient rows scattered
# back by the dense exchange (a copy of ``collectives.py:91-117``).
ATTR_COLS = 16
GRAD_ROWS = 9


def _size(group) -> int:
    return dist.get_world_size(group)


def _index(group) -> int:
    return dist.get_rank(group)


def for_backend(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` detached and contiguous where the group's backend reads it:
    host memory for a gloo group, else where it lies."""
    x = x.detach()
    if x.device.type != "cpu" and dist.get_backend(group) == "gloo":
        x = x.cpu()
    return x.contiguous()


def gather_chunks(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape), in group order."""
    s = _size(group)
    if s == 1:
        return [x]
    xb = for_backend(x, group).reshape(-1)  # gloo takes only the concatenated output
    out = xb.new_empty((s * xb.shape[0],))
    dist.all_gather_into_tensor(out, xb, group=group)
    return list(out.to(x.device).view(s, *x.shape).unbind(0))


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's equal slice along ``dim``."""
    s = _size(group)
    if s == 1:
        return x
    xb = for_backend(x.movedim(dim, 0), group)
    out = xb.new_empty((xb.shape[0] // s, *xb.shape[1:]))
    dist.reduce_scatter_tensor(out, xb, group=group)
    return out.to(x.device).movedim(0, dim)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``x`` over the group; returns ``x``."""
    if _size(group) == 1:
        return x
    xb = for_backend(x, group)
    dist.all_reduce(xb, group=group)
    if xb.data_ptr() != x.data_ptr():  # staged through the host, or made contiguous
        x.copy_(xb)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(gather_chunks(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in group order (the
    tiled ``lax.all_gather``); its backward sums the cotangents over the
    group and returns this rank's slice (``psum_scatter``)."""
    return _AllGather.apply(x, group, dim)


class _GatherStrips(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return torch.cat(gather_chunks(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        i = _index(ctx.group)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None


def gather_strips(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Concatenate every rank's strip along ``dim``; the backward keeps this
    rank's slice of the cotangent (every rank computes the same loss from
    the gathered image)."""
    return _GatherStrips.apply(x, group, dim)


def _shift(down: torch.Tensor, up: torch.Tensor, group):
    """Send ``down`` to the next rank of the group and ``up`` to the
    previous one; returns (from the previous, from the next), zeros at the
    ends of the chain."""
    s, i = _size(group), _index(group)
    from_prev, from_next = torch.zeros_like(down), torch.zeros_like(up)
    if s == 1:
        return from_prev, from_next
    ranks = dist.get_process_group_ranks(group)
    bufs, ops = [], []
    if i + 1 < s:
        snd, rcv = for_backend(down, group), for_backend(from_next, group)
        ops += [dist.P2POp(dist.isend, snd, ranks[i + 1], group),
                dist.P2POp(dist.irecv, rcv, ranks[i + 1], group)]
        bufs.append((rcv, from_next))
    if i > 0:
        snd, rcv = for_backend(up, group), for_backend(from_prev, group)
        ops += [dist.P2POp(dist.isend, snd, ranks[i - 1], group),
                dist.P2POp(dist.irecv, rcv, ranks[i - 1], group)]
        bufs.append((rcv, from_prev))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for rcv, dst in bufs:
        if rcv.data_ptr() != dst.data_ptr():
            dst.copy_(rcv)
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, group, halo):
        ctx.group, ctx.halo, ctx.rows = group, halo, img.shape[1]
        return _shift(img[:, -halo:], img[:, :halo], group)

    @staticmethod
    def backward(ctx, d_top, d_bot):
        # The top halo came from the previous rank's last rows, the bottom
        # halo from the next rank's first rows: each cotangent goes back.
        from_prev, from_next = _shift(d_bot, d_top, ctx.group)
        h, rows = ctx.halo, ctx.rows
        g = from_prev.new_zeros((from_prev.shape[0], rows, *from_prev.shape[2:]))
        g[:, :h] += from_prev
        g[:, rows - h:] += from_next
        return g, None, None


def halo_exchange(img: torch.Tensor, group, halo: int):
    """(top, bottom) context rows of the strip ``img`` [B, rows, ...]: the
    previous rank's last ``halo`` rows and the next rank's first ``halo``
    rows, zeros past the ends of the chain (the image's zero padding). The
    backward returns each cotangent to the rank the rows came from."""
    return _Halo.apply(img, group, halo)


def ring_all_reduce(tensors: dict, group) -> dict:
    """``all_reduce`` (sum) of a dict of tensors by a ring of point-to-point
    steps: the tensors are flattened into one vector cut into S segments;
    S-1 reduce-scatter steps leave each rank one summed segment, S-1
    all-gather steps circulate them. Equal to ``all_reduce`` up to the
    order of the adds; the identity at S = 1."""
    s = _size(group)
    if s == 1 or not tensors:
        return dict(tensors)
    i = _index(group)
    keys = list(tensors)
    dev = tensors[keys[0]].device
    flat = for_backend(torch.cat([tensors[k].detach().reshape(-1) for k in keys]), group)
    n = flat.shape[0]
    seg = -(-n // s)
    xp = torch.nn.functional.pad(flat, (0, seg * s - n)).reshape(s, seg)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(i + 1) % s], ranks[(i - 1) % s]

    def step(buf):
        out = torch.empty_like(buf)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, nxt, group),
                                           dist.P2POp(dist.irecv, out, prv, group)]):
            req.wait()
        return out

    # Reduce-scatter: at step t, pass the running segment (i - t) mod s on
    # and fold in this rank's part of the one received; after S-1 steps
    # this rank holds the sum of segment (i + 1) mod s.
    buf = xp[i].clone()
    for t in range(s - 1):
        buf = step(buf) + xp[(i - t - 1) % s]
    # All-gather: circulate the summed segments.
    out = torch.empty_like(xp)
    for t in range(s - 1):
        out[(i + 1 - t) % s] = buf
        buf = step(buf)
    out[(i + 2 - s) % s] = buf
    red = out.reshape(-1)[:n].to(dev)
    result, off = {}, 0
    for k in keys:
        size = tensors[k].numel()
        result[k] = red[off:off + size].reshape(tensors[k].shape)
        off += size
    return result


def allreduce_bytes(num_params: int, axis_size: int, dtype_bytes: int = 4) -> dict:
    """Communication volume per rank of one gradient all-reduce."""
    total = num_params * dtype_bytes
    ring = 2 * (axis_size - 1) / axis_size * total
    return dict(
        grad_bytes=total,
        ring_bytes_per_device=int(ring),
        steps=2 * (axis_size - 1),
        bytes_per_step=int(ring / max(2 * (axis_size - 1), 1)),
    )


def tile_exchange_bytes(n: int, shards: int) -> dict:
    """Per-rank volume of the dense attribute exchange at N Gaussians."""
    return dict(
        allgather=n * ATTR_COLS * 4 * (shards - 1) // shards,
        psum_scatter=n * GRAD_ROWS * 4 * (shards - 1) // shards,
    )
