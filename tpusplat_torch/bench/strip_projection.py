"""Condensed strip measurement (counterpart of
``tpusplat/bench/strip_projection.py``): per-strip forward and backward
through the dense-exchange strip pipeline (strip compaction on) on one card,
and the projection of the n-card frame by the arithmetic of
:func:`tpusplat_torch.bench.strip_bench.project`, with the exchange at 50%
of the H100's NVLink rate per direction. The full version, with the
forward-only and compact-exchange variants, is
:mod:`tpusplat_torch.bench.strip_bench`.
"""

from __future__ import annotations

import torch

from tpusplat_torch.bench._timing import clock, time_ms
from tpusplat_torch.bench.strip_bench import (
    preprocess_fwd_bwd, project, shard_of, strip_capacity, strip_fwd_bwd,
)


def measure_strip_projection(params, cam, cfg, shards: int = 8, iters: int = 4,
                             t_full_ms: float | None = None) -> dict:
    """Measure each strip's forward and backward on this card and project
    the ``shards``-card frame. Returns strip_ms_max, strip_ms, comm_ms,
    frame_ms, mpix_per_s and, when ``t_full_ms`` (one card's measured whole
    frame, forward and backward) is given, scaling_eff_vs_1card."""
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.parallel.collectives import tile_exchange_bytes

    device = params.device
    n, w, h = params.num_gaussians, cam.width, cam.height
    _, tiles_y = cfg.tile_grid(w, h)
    nrows = -(-tiles_y // shards)
    gcap = cfg.strip_gauss_capacity(n, nrows, tiles_y)
    with torch.no_grad():
        cap = strip_capacity(int(preprocess(params, cam, cfg).ntiles.sum()), shards)
    strip_ms = []
    for s in range(shards):
        ms, (_, _, ovf) = time_ms(
            lambda row0=s * nrows: strip_fwd_bwd(params, cam, cfg, row0, nrows, cap, gcap),
            device, iters)
        if int(ovf):
            raise AssertionError(f"strip_projection: strip {s} overflow {int(ovf)}")
        strip_ms.append(ms)
    # Preprocess forward and backward at both sizes: the strips above
    # differentiate through the whole frame's, a sharded card only its
    # shard's.
    shard = shard_of(params, shards)
    pre_shard, _ = time_ms(lambda: preprocess_fwd_bwd(shard, cam, cfg), device, 40)
    pre_full, _ = time_ms(lambda: preprocess_fwd_bwd(params, cam, cfg), device, 10)
    xb = tile_exchange_bytes(n, shards)
    p = project(max(strip_ms), pre_full, pre_shard, xb["allgather"], xb["psum_scatter"], shards,
                w * h / 1e6, t_full_ms)["nvlink_50pct"]
    return dict(clock=clock(device), strip_ms_max=max(strip_ms), strip_ms=strip_ms,
                comm_ms=p["comm_ms"], frame_ms=p["frame_ms"], mpix_per_s=p["mpix_per_s"],
                scaling_eff_vs_1card=p["scaling_eff_vs_1card"], link_gbps=p["gbps"])
