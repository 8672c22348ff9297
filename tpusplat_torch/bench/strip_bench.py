"""Strip-mode measurements on one card (counterpart of
``tpusplat/bench/strip_bench.py``): the per-card inputs of a projection of
the tile-sharded frame over n cards.

A tile-sharded frame (:mod:`tpusplat_torch.parallel.sharded`) does, per card:

  1. preprocess its N/n Gaussian shard,
  2. all-gather the screen-space attributes over NVLink,
  3. bin, sort and blend (forward and backward) only its strip of tile
     rows, at about C/n instance capacity,
  4. reduce-scatter the attribute gradients back (the transpose of 2).

Steps 1 and 3 are one card's work at shard scale: this bench measures them
for every strip (row0 = 0 .. n-1 strips). The byte volumes of steps 2 and 4
are exact (``tile_exchange_bytes``); the one number not measured is the
link's rate: NVIDIA's H100 SXM data sheet gives NVLink 900 GB/s a card,
450 GB/s each way, and the projection reports 50% and 100% of it. The
JAX bench's production-precision variant is left out: ``mm_precision``
has no effect in the port, so it would time the dense loop again.

    python -m tpusplat_torch.bench.strip_bench [n_shards]
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from tpusplat_torch.bench._timing import clock, emit, require_card, time_ms
from tpusplat_torch.train.step import TRAINABLE

# NVIDIA H100 SXM5 data sheet: NVLink 900 GB/s a card, both directions.
NVLINK_GBPS_PER_DIRECTION = 450.0


def _leaves(params):
    leaves = {f: getattr(params, f).detach().requires_grad_(True) for f in TRAINABLE}
    return dataclasses.replace(params, **leaves), list(leaves.values())


def strip_render(params, cam, cfg, row0: int, nrows: int, cap: int, gcap):
    """(strip image, instances, overflow) of the dense strip pipeline."""
    from tpusplat_torch.ops.binning import bin_and_sort
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.ops.rasterize import rasterize

    pg = preprocess(params, cam, cfg)
    binned = bin_and_sort(pg, cam.width, cam.height, cfg, row0, nrows, cap,
                          gauss_capacity=gcap)
    img, aux = rasterize(pg, binned, cam.width, cam.height, cfg, row0, nrows)
    return img, aux["num_instances"], aux["capacity_overflow"] + aux["gauss_overflow"]


def strip_fwd_bwd(params, cam, cfg, row0, nrows, cap, gcap):
    """One strip's forward and backward: d sum(img^2) / d params."""
    p, leaves = _leaves(params)
    img, inst, ovf = strip_render(p, cam, cfg, row0, nrows, cap, gcap)
    return torch.autograd.grad(torch.sum(img * img), leaves), inst, ovf


def preprocess_fwd_bwd(params, cam, cfg):
    """Preprocess and its backward (the part of a strip's step that a
    sharded card pays on its N/n shard only). Depth is left out of the loss:
    it reaches the blend only detached (binning, the exchange table), and
    the kernels' route gives it no gradient."""
    from tpusplat_torch.ops.preprocess import preprocess

    p, leaves = _leaves(params)
    pg = preprocess(p, cam, cfg)
    loss = pg.uv.sum() + pg.conic.sum() + pg.opacity.sum() + pg.color.sum()
    return torch.autograd.grad(loss, leaves)


def shard_of(params, shards: int):
    """The first of ``shards`` equal Gaussian shards."""
    k = params.num_gaussians // shards
    return dataclasses.replace(params, **{f.name: getattr(params, f.name)[:k]
                                          for f in dataclasses.fields(params)})


def strip_capacity(needed: int, shards: int) -> int:
    """A strip's instance capacity: an even split of the frame's instances
    with 35% for imbalance, rounded up to 1024."""
    return max(1024, -(-int(needed / shards * 1.35) // 1024) * 1024)


def project(strip_max_ms: float, pre_full_ms: float, pre_shard_ms: float, fwd_bytes: int,
            bwd_bytes: int, shards: int, mpix: float, t_full_ms: float | None,
            link_gbps: float = NVLINK_GBPS_PER_DIRECTION) -> dict:
    """The per-card frame of the sharded path (``strip_bench.py:267-305`` of
    the JAX package): the slowest strip less the whole frame's preprocess
    (forward and backward) plus the shard's, plus the exchange's bytes at
    50% and 100% of ``link_gbps``. Returns the pipeline ms and, per rate,
    comm ms, frame ms, Mpix/s and the efficiency against one card's whole
    frame (``t_full_ms``; None without it)."""
    pipe = strip_max_ms - pre_full_ms + pre_shard_ms
    out = {"pipe_ms_per_card": pipe}
    for frac, label in ((0.5, "nvlink_50pct"), (1.0, "nvlink_100pct")):
        comm_ms = (fwd_bytes + bwd_bytes) / (frac * link_gbps * 1e6)
        frame_ms = pipe + comm_ms
        out[label] = dict(gbps=frac * link_gbps, comm_ms=comm_ms, frame_ms=frame_ms,
                          mpix_per_s=mpix / frame_ms * 1e3,
                          scaling_eff_vs_1card=(t_full_ms / (shards * frame_ms)
                                                if t_full_ms else None))
    return out


def full_frame_ms(params, cam, cfg, device, reps: int) -> float:
    """One card's whole frame, forward and backward."""
    from tpusplat_torch.render import render_stages

    def full():
        p, leaves = _leaves(params)
        img, aux = render_stages(p, cam, cfg)
        return torch.autograd.grad(torch.sum(img * img), leaves), aux["capacity_overflow"]

    ms, (_, ovf) = time_ms(full, device, reps)
    if int(ovf):
        raise AssertionError(f"strip_bench: the whole frame overflowed ({int(ovf)})")
    return ms


def run(shards: int = 8, device="cuda", conf="garden", reps: int = 6) -> dict:
    from tpusplat_torch.bench.profile_detail import scene
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.parallel.collectives import tile_exchange_bytes
    from tpusplat_torch.parallel.compact_grad import (
        CompactStatic, a2a_bucket_cap, exchange_render_emulated, pack_exchange_table,
    )

    params, cam, cfg = scene(conf, device)
    n, w, h = params.num_gaussians, cam.width, cam.height
    tiles_x, tiles_y = cfg.tile_grid(w, h)
    nrows = -(-tiles_y // shards)
    res: dict = dict(clock=clock(device), n=n, w=w, h=h, shards=shards, nrows=nrows)

    def t(fn, r=reps):
        return time_ms(fn, device, r)

    params_shard = shard_of(params, shards)
    with torch.no_grad():
        res["t_preprocess_shard_ms"], _ = t(lambda: preprocess(params_shard, cam, cfg), 20)
        res["t_preprocess_full_ms"], pg = t(lambda: preprocess(params, cam, cfg))
    needed = int(pg.ntiles.sum())
    cap = strip_capacity(needed, shards)
    gcap = cfg.strip_gauss_capacity(n, nrows, tiles_y)
    res.update(instances_total=needed, cap_strip=cap, gauss_capacity_strip=gcap)

    fwd_ms, bwd_ms, inst = [], [], []
    for s in range(shards):
        row0 = s * nrows
        with torch.no_grad():
            ms, _ = t(lambda row0=row0: strip_render(params, cam, cfg, row0, nrows, cap, gcap))
        fwd_ms.append(ms)
        ms, (_, k, ovf) = t(lambda row0=row0: strip_fwd_bwd(params, cam, cfg, row0, nrows,
                                                            cap, gcap))
        if int(ovf):
            raise AssertionError(f"strip_bench: strip {s} overflow {int(ovf)} (cap {cap})")
        bwd_ms.append(ms)
        inst.append(int(k))
    res.update(strip_fwd_only_ms=fwd_ms, strip_fwd_bwd_ms=bwd_ms, strip_instances=inst,
               strip_ms_max=max(bwd_ms), strip_ms_mean=sum(bwd_ms) / shards)

    # The compact exchange, emulated on one card: the S-shard path's shapes
    # and data with the all-to-all as the identity; the dense loop above is
    # the dense exchange's per-card cost.
    compact_ms = []
    if gcap is not None and n % shards == 0:
        st = CompactStatic(cfg=cfg, width=w, height=h, nrows=nrows, cap_shard=cap, gcap=gcap,
                           n_total=n, n_local=n // shards, n_shards=shards)

        def compact(row0):
            p, leaves = _leaves(params)
            img, counters = exchange_render_emulated(
                pack_exchange_table(preprocess(p, cam, cfg))[None], st, row0)
            return torch.autograd.grad(torch.sum(img * img), leaves), counters

        for s in range(shards):
            ms, (_, counters) = t(lambda row0=s * nrows: compact(row0))
            c = counters.sum(0)
            if int(c[0]) or int(c[2]) or int(c[3]):
                raise AssertionError(f"strip_bench: compact strip {s} overflow {c.tolist()}")
            compact_ms.append(ms)
        res.update(a2a_bucket_cap=a2a_bucket_cap(st), strip_fwd_bwd_compact_ms=compact_ms,
                   strip_compact_ms_max=max(compact_ms))

    res["t_preprocess_fwdbwd_full_ms"], _ = t(lambda: preprocess_fwd_bwd(params, cam, cfg))
    res["t_preprocess_fwdbwd_shard_ms"], _ = t(
        lambda: preprocess_fwd_bwd(params_shard, cam, cfg), 20)

    xb = tile_exchange_bytes(n, shards)
    res.update(allgather_bytes=xb["allgather"], reduce_scatter_bytes=xb["psum_scatter"])

    res["t_full_frame_1card_ms"] = full_frame_ms(params, cam, cfg, device, reps)

    mpix = w * h / 1e6
    pre = (res["t_preprocess_fwdbwd_full_ms"], res["t_preprocess_fwdbwd_shard_ms"])
    res["projection"] = project(res["strip_ms_max"], *pre, xb["allgather"], xb["psum_scatter"],
                                shards, mpix, res["t_full_frame_1card_ms"])
    if compact_ms:
        a2a_bytes = (16 + 1) * res["a2a_bucket_cap"] * 4 * (shards - 1)
        res["a2a_bytes"] = a2a_bytes
        res["projection_compact"] = project(res["strip_compact_ms_max"], *pre,
                                            xb["allgather"], a2a_bytes, shards, mpix,
                                            res["t_full_frame_1card_ms"])
    # Viewer mode: the forward needs the all-gather and no gradient back.
    fwd = project(max(fwd_ms), res["t_preprocess_full_ms"], res["t_preprocess_shard_ms"],
                  xb["allgather"], 0, shards, mpix, None)["nvlink_50pct"]
    res["projection_viewer"] = dict(frame_ms=fwd["frame_ms"], fps=1e3 / fwd["frame_ms"],
                                    mpix_per_s=fwd["mpix_per_s"])
    res["link"] = dict(gbps_per_direction=NVLINK_GBPS_PER_DIRECTION,
                       source="NVIDIA H100 SXM5 data sheet: NVLink 900 GB/s a card, both ways")
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not require_card("strip_bench"):
        return 1
    emit(run(int(argv[0]) if argv else 8))
    return 0


if __name__ == "__main__":
    sys.exit(main())
