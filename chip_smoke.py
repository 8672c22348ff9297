"""Smoke run of the PyTorch/CUDA port (tpusplat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each; any failure exits non-zero:
  1. device: a CUDA device is required (exit 1 without one); prints its
     name and ``nvidia-smi``'s name and power limit;
  2. build: compiles every kernel of the serving and training paths from
     ``csrc/`` with nvcc (in parallel) and prints the ptxas resource report;
     a register spill fails the run;
  3. parity at 100k Gaussians, 800x800, SH3 (BASELINE config 2): the
     emission kernel against its plain version (bit-equal), here and on
     adversarial meta built from a seed (no instance, one Gaussian owning
     more slots than a block, capacity ending inside a Gaussian, a total
     past INT32_MAX, long runs of zero-count Gaussians, a compacted stream
     with another sentinel and row0 != 0, more Gaussians than the scan has
     chunks); the CUDA bin_and_sort against the CPU one on the same
     preprocessed Gaussians (bit-equal), the forward-blend kernel against
     its plain version (image atol 3e-5 rtol 1e-4, transmittance atol
     3e-5), the backward-blend kernel against its plain version (autograd
     of the plain blend) on seeded cotangents of the image and of T (each of
     the 9 gradient rows normalised by its largest magnitude, atol 1e-4);
     both blend kernels again on an adversarial copy of the slab
     (opacities at alpha_min x (1 +- 1e-4), conics pushed to
     b = 0.999 sqrt(ac)) that tests their cull, and on 12x8 and 64x1 tiles
     (their warps then row-major), and the segment reduce against its plain
     version (atol 1e-4);
  4. grad_6k: the gradients of all five parameters through the whole CUDA
     pipeline against the plain pipeline on the CPU, same inputs, at 6k
     Gaussians, 128x128, SH3 (normalised atol 1e-4);
  5. garden serving: 1.4M Gaussians at 1920x1080, SH3, tight radius,
     capacity from a preprocess probe x1.05; ``render_auto`` on a 3-camera
     orbit with the launch counters reset just before and read just after;
  6. garden training: ``train_step`` at the same shapes against renders of
     a second random scene, one warm-up step and three timed steps with the
     regrow retry, counters reset just before and read just after; then one
     step split into forward, backward and Adam;
  7. kernels at the garden shapes: each against its plain version, timed
     with CUDA events beside its bound, the plain version's time and, where
     one PyTorch call computes the same function, that call's time; the
     emission kernel's own time (its C call on inputs made beforehand)
     beside its wrapper's; the backward blend and the segment reduce
     launched twice and bit-equal; the share of (instance, warp) pairs the
     blend kernels' cull skips, and how many of the pairs the backward
     walks hold a passing pixel;
     the run lengths the segment reduce sees; the segment reduce on
     adversarial ids (a run of 1e5 rows, empty runs, NaN sentinels);
  8. trainer rehearsal: ``python -m tpusplat_torch.trainer --synthetic``
     for 30 steps at 128x128; the loss must fall;
  9. threefry: the densify draws (``prng``: jax.random's threefry stream
     and normal) on the card against the CPU, bit for bit: the normal of
     all 2**23 uniforms it can draw, and the bits and normals of the
     trainer's first densify pair at [1.4M, 3]; the pair's milliseconds;
 10. data_training: the trainer's real-data path at the garden shapes. A
     COLMAP capture written to disk (16 orbit views of the garden scene at
     1920x1080 as PNGs, one PINHOLE camera, 100k SfM points drawn from its
     means and coloured from their SH DC) and read back with
     ``load_colmap_scene`` (view and projection matrices within 1e-5,
     images within 0.5/255 + 1e-6); ``trainer.main(["--data", ...,
     "--holdout", "8", "--steps", "60", "--capacity", "1400000", "--ckpt",
     ..., "--watchdog-secs", "300", ...])`` with the launch counters reset
     just before and read just after (the loss falls, the held-out PSNR
     rises, two held-out views, overflow 0 in every logged line, each
     kernel launched at least once a step, every densify round's split
     noise drawn on the card at [1.4M, 3]); the checkpoint in the JAX
     package's layout (exactly ``leaf_0`` ... ``leaf_25`` and
     ``__treedef__``, the treedef the port's constant, every leaf JAX's
     shape and dtype at 1.4M slots and SH3), loaded onto the card equal to
     the final state, and one ``train_step`` from each bit-equal; the
     trained ``.ply`` read natively and with numpy, equal;
     a garden frame with ``debug_checks`` (every counter 0, image and T
     bit-equal to the frame without), ``render`` raising on a NaN mean,
     the clean frame bit-equal afterwards; ``render_batch`` of the orbit
     bit-equal to one ``render_stages`` a camera; a densify round that
     grants slots at 1.4M (``densify_round``: 1.0M alive, more candidates
     than free slots, clones, splits and prunes) on the card against the
     same round on the CPU given the card's draws (alive and the granted
     slots bit-equal, the rest within 2e-6, a differing clone-or-split
     decision only within 4 ulp of its limit), its ms; the seconds of each
     part (the checkpoint's save and load among them);
 11. sharded_emulated: one strip of the tile-sharded path at the garden
     shapes (tile = 4, 17 tile rows a strip, strip_gauss_mult 2.0: strip
     compaction active, or the run fails) through
     ``exchange_render_emulated``, forward and backward, the launch counters
     reset just before and read just after; the segment reduce's
     streamed-target and multi-range kernels on that strip's ids, with its
     gradient rows and with seeded random rows: bit-equal to the runs route
     (the dense kernel over runs searched by ``torch.searchsorted``,
     ``target_runs`` and ``multirange_runs``), launched twice and
     bit-equal, within atol 1e-4 of their plain versions; both on
     adversarial exchange blocks (a block wholly of sentinels, a run of 100
     rows, an id in every block, the id n - 1, NaN sentinel rows; values
     exact in float32, so bit-equal to the plain versions too); each timed
     as its C call alone and as its wrapper beside the runs route, its
     bytes bound, its plain version and, for the multi-range mode, one
     ``index_add_``; the strip's split (binning, forward kernel, backward
     kernel, gid sort, bucket_targets, reduce, owner_local_ids, owner
     reduce);
 12. sharded_two_process: two processes on the one card (gloo through host
     memory: NCCL cannot run two ranks on one card), mesh 1x2, 100k
     Gaussians at 800x800, SH3: one ``sharded_train_step`` with the dense
     exchange, one with the compact one, and ``sharded_train_step_overlap``
     with the ring and with the all-reduce, each from the same state, each
     against the one-process ``train_step`` (loss rtol 1e-5; means, sh and
     opacities after the update atol 2e-6, 3e-6 after an overlap step, the
     JAX package's bounds; Adam's moments, which hold the gradient's
     magnitude, within 1e-4 of their largest; compact against dense 3e-6
     and 1e-5), with zero overflow and compaction active;
 13. session: the interactive loop (``run_interactive``) on a ``Session`` of
     the garden scene at 1920x1080, fov 60, from (0, 0.5, 9), keys w w d
     left up, profiled every second frame, the launch counters reset just
     before and read just after (emission and forward every frame): the
     position within 1e-9 of the motion constants' result, frame 0 and a
     frame after ``resize(1280, 720)`` bit-equal to ``render_auto`` at the
     same camera, the status and live stage lines in the overlay; the frame
     ms, the EMA and the stage ms;
 14. dryrun: ``run_dryrun(4)``, four ranks on the one card over gloo (mesh
     2x2): the sharded render against the one-process render, the overlap
     step's loss against the monolithic one's, the compact exchange
     against the dense one; every rank launches every kernel;
 15. profile_detail: the garden stage table and a ``torch.profiler``
     window over three train steps (window ms, device-busy ms, idle share,
     launches a step, the ten kernels with the most device time), and the
     same steps unprofiled;
 16. gpu_gate: the gate's five checks (CUDA against the plain path at
     100k/800^2 and its production block, the strip path, the golden
     oracle at 6k/128^2, the compact exchange); fails unless all pass;
 17. bench_tools: kernel_bench (twice: inputs built, then cached),
     plumb_bench, micro, strip_bench 8, measure_strip_projection and
     scaling (two ranks on the card over gloo), each once at the garden
     shapes, its JSON and seconds logged;
 18. headline: ``bench.headline`` (``bench.py``'s counterpart: the MSE
     step's forward and backward, host-differenced) in process at small,
     mid, garden (the fwd+bwd, viewer and strip lines) and bicycle (6M
     Gaussians at 1600x1063, the fwd+bwd line), 5 iterations, the launch
     counters reset just before each run and read just after, then one
     step with the counters reset; each configuration's settled capacity
     (garden's and bicycle's beside the JAX package's recorded ones), peak
     memory and lines; fails on overflow, a time or rate not finite and
     positive, a black image or a kernel of the step not launched.
The line before the last is the ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --nccl

runs only phase 12's steps with a card per rank over NCCL (the path of
``trainer --mesh`` under torchrun), on the meshes 1x4 and 2x2 (one camera
per data rank, against the one-process step on the same batch); it needs
four cards.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W power limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Floating-point operations of the blend per (instance, pixel) pair up to
# the alpha test: dx, dy, dx^2, dy^2, dx*dy, three coefficient products, two
# sums, exp, the opacity product and the clamp.
BLEND_FLOPS_PER_PAIR = 13
# The backward blend's further operations per passing pair and per pair
# that contributes colour (counted from csrc/rasterize_backward.cu's code,
# see its note).
BACKWARD_FLOPS_PER_PASSING_PAIR = 34
BACKWARD_FLOPS_PER_CONTRIB_PAIR = 16
GRAD_FIELDS = ("means", "log_scales", "quats", "opacities", "sh")

# The configurations: BASELINE config 2, the TPU gate's small one, and the
# garden shapes of bench.py:43.
PARITY = dict(n=100_000, width=800, height=800)
GRAD = dict(n=6000, width=128, height=128)
GARDEN = dict(n=1_400_000, width=1920, height=1080)
# Tiles whose warps in the backward kernel are 32 consecutive pixels: a warp
# spans rows from the middle of one (12x8), or lies in one row away from its
# start (64x1).
ROW_MAJOR_TILES = ((12, 8), (64, 1))
REHEARSAL = ["--synthetic", "--steps", "30", "--width", "128", "--height", "128",
             "--n-init", "2000", "--log-every", "10", "--densify-every", "10"]
# The tile-sharded phases: tile shards of the emulated garden strip (17 tile
# rows of 68) and its stream multiplier; the two-process mesh.
SHARDED_TILE, SHARDED_STRIP, SHARDED_GAUSS_MULT = 4, 1, 2.0
TWO_PROCESS_MESH = (1, 2)
# ``--nccl``: the meshes over a card per rank.
NCCL_MESHES, NCCL_CARDS = [(1, 4), (2, 2)], 4


def log(**kw):
    print(json.dumps(kw), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events on the current stream, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_close(name, got, want, atol, rtol=0.0) -> float:
    err = float((got - want).abs().max())
    bad = ((got - want).abs() > atol + rtol * want.abs()).sum().item()
    if bad or not math.isfinite(err):
        fail(f"{name}: {bad} elements outside atol {atol} rtol {rtol} (max abs err {err})")
    return err


def check_equal(name, got, want):
    if got is None or want is None:  # an optional field (stream_ids)
        if got is not want:
            fail(f"{name}: one side is None")
        return
    if got.shape != want.shape or not bool((got.cpu() == want.cpu()).all()):
        diff = (got.cpu() != want.cpu()).sum().item() if got.shape == want.shape else "shape"
        fail(f"{name}: not bit-equal ({diff} differ)")


def orbit_cameras(look_at_camera, eye, target, width, height, fov, frames, device):
    """The cameras of ``viewer --orbit frames``: the eye rotated about the
    y axis through the target."""
    import numpy as np

    center = np.asarray(target, np.float64)
    radius_vec = np.asarray(eye, np.float64) - center
    cams = []
    for i in range(frames):
        ang = 2 * np.pi * i / frames
        rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]])
        cams.append(look_at_camera(center + rot @ radius_vec, center, width, height,
                                   fov_deg=fov, device=device))
    return cams


def check_rows(name, got, want, atol=1e-4) -> float:
    """Each row of [K, M] ``got`` against ``want``, normalised by the row's
    largest magnitude in ``want``; returns the largest normalised error."""
    worst = 0.0
    for k in range(want.shape[0]):
        scale = float(want[k].abs().max()) + 1e-12
        err = float((got[k] - want[k]).abs().max()) / scale
        if not math.isfinite(err) or err > atol:
            fail(f"{name}: row {k} off by {err} of its max {scale} (normalised atol {atol})")
        worst = max(worst, err)
    return worst


def bound(nbytes, nops):
    """Least time (ms) on the card and what bounds it."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, nops / PEAK_FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def seeded_cotangents(torch, img, tmap, seed):
    g = torch.Generator(device=img.device).manual_seed(seed)
    return (torch.randn(img.shape, generator=g, device=img.device),
            torch.randn(tmap.shape, generator=g, device=img.device))


def random_rows(torch, gauss_id, n, seed):
    """Standard-normal gradient rows [9, C] (tests/test_compact_grad.py's
    inputs), NaN in the slots whose id is the sentinel N, as stale memory."""
    g = torch.Generator(device=gauss_id.device).manual_seed(seed)
    rows = torch.randn((9, gauss_id.shape[0]), generator=g, device=gauss_id.device)
    return torch.where(gauss_id[None, :] < n, rows, float("nan"))


def pair_counts(torch, attr, starts, ends, tiles_x, row0, width, crop_h, cfg, tb=32):
    """(visited, passing, contributing) (instance, pixel) pairs of the blend
    walk over the pixels inside the output; the (instance, warp) pairs in
    which some pixel passes, the ones the backward kernel must sum (its
    warps are ``warp_pixels``); and the (instance, warp) pairs that a walk
    with the kernels' cull must take: the instance's pass box
    (``pass_extent_plain``) meets the warp's rectangle, and some pixel of
    the warp inside the output still has T > 0 (a pixel at T == 0 stays as
    it is). The data-dependent work of both blend kernels' bounds."""
    from tpusplat_torch.ops.rasterize import pass_extent_plain, warp_pixels

    num_tiles = starts.shape[0]
    npx = cfg.tile_w * cfg.tile_h
    dev = attr.device
    cap = attr.shape[1]
    lin = torch.arange(npx, device=dev)
    lx, ly = lin % cfg.tile_w, lin // cfg.tile_w
    counts = (ends - starts).long()
    totals = torch.zeros(5, dtype=torch.int64, device=dev)
    lanes = warp_pixels(cfg.tile_w, cfg.tile_h).flatten().to(dev)
    nw = npx // 32
    batch_k = torch.nn.functional.pad(counts, (0, -num_tiles % tb)).reshape(-1, tb)
    for bi, k in enumerate(batch_k.max(dim=1).values.tolist()):
        tiles = torch.arange(bi * tb, min((bi + 1) * tb, num_tiles), device=dev)
        if k == 0:
            continue
        ix = (tiles % tiles_x)[:, None] * cfg.tile_w + lx[None, :]
        iy = (tiles // tiles_x)[:, None] * cfg.tile_h + ly[None, :]
        inside = (ix < width) & (iy < crop_h)  # [B, P]
        px, py = ix.float(), (iy + row0 * cfg.tile_h).float()
        # Each warp's rectangle [B, W]: x lo, x hi, y lo, y hi.
        rect = [f(v[:, lanes].reshape(-1, nw, 32), -1) for v in (px, py)
                for f in (torch.amin, torch.amax)]
        t_acc = torch.ones(inside.shape, device=dev)
        for k0 in range(0, k, 256):
            ks = torch.arange(k0, min(k0 + 256, k), device=dev)
            valid = ks[None, :] < counts[tiles][:, None]  # [B, K]
            a = attr[:, torch.clamp_max(starts[tiles].long()[:, None] + ks[None, :], cap - 1)]
            dx = a[0][..., None] - px[:, None, :]  # [B, K, P]
            dy = a[1][..., None] - py[:, None, :]
            power = -0.5 * (a[2][..., None] * dx * dx + a[4][..., None] * dy * dy) \
                - a[3][..., None] * dx * dy
            alpha = torch.clamp_max(a[5][..., None] * torch.exp(power), cfg.alpha_max)
            seen = valid[..., None] & inside[:, None, :]
            ok = seen & (power <= 0) & (alpha >= cfg.alpha_min)
            t_incl = t_acc[:, None, :] * torch.cumprod(torch.where(ok, 1 - alpha, 1.0), dim=1)
            live_warps = ok[..., lanes].reshape(*ok.shape[:2], nw, 32).any(-1)
            t_excl = torch.cat([t_acc[:, None, :], t_incl[:, :-1, :]], dim=1)
            open_warps = (seen & (t_excl > 0))[..., lanes].reshape(*ok.shape[:2], nw, 32).any(-1)
            hx, hy = pass_extent_plain(a[2:5].reshape(3, -1).T, a[5].reshape(-1),
                                       cfg.alpha_min).reshape(*a.shape[1:], 2).unbind(-1)
            box = [(a[0] - hx)[..., None], (a[0] + hx)[..., None],
                   (a[1] - hy)[..., None], (a[1] + hy)[..., None]]
            miss = (box[0] > rect[1][:, None, :]) | (box[1] < rect[0][:, None, :]) \
                | (box[2] > rect[3][:, None, :]) | (box[3] < rect[2][:, None, :])
            totals += torch.stack([seen.sum(), ok.sum(), (ok & (t_incl >= cfg.t_min)).sum(),
                                   live_warps.sum(), (open_warps & ~miss).sum()])
            t_acc = t_incl[:, -1, :]
    return [int(v) for v in totals.tolist()]


def cull_counts(torch, attr, tile_id, tiles_x, row0, cfg):
    """(instance, warp) pairs of the blend walks, and how many of them the
    blend kernels' cull skips: the instance's box (``pass_extent_plain``)
    misses the rectangle of the warp's pixels (``warp_pixels``). Counted
    over every instance of the ranges, as if no tile stopped early."""
    from tpusplat_torch.ops.rasterize import pass_extent_plain, warp_pixels

    tw, th = cfg.tile_w, cfg.tile_h
    wp = warp_pixels(tw, th).to(attr.device)
    wx, wy = wp % tw, wp // tw
    x = (tile_id % tiles_x).long()[:, None] * tw
    y = ((tile_id // tiles_x).long()[:, None] + row0) * th
    h = pass_extent_plain(attr[2:5].T, attr[5], cfg.alpha_min)
    uvx, uvy = attr[0][:, None], attr[1][:, None]
    culled = (uvx - h[:, :1] > (x + wx.amax(1)).float()) \
        | (uvx + h[:, :1] < (x + wx.amin(1)).float()) \
        | (uvy - h[:, 1:] > (y + wy.amax(1)).float()) \
        | (uvy + h[:, 1:] < (y + wy.amin(1)).float())
    return culled.numel(), int(culled.sum())


def adversarial_slab(torch, attr, alpha_min, seed):
    """A copy of the slab that stresses the backward kernel's cull: a third
    of the instances at opacity alpha_min x (1 +- 1e-4), whose pass extent
    shrinks to about a pixel, and a quarter with b = 0.999 sqrt(ac), near
    singular."""
    g = torch.Generator(device=attr.device).manual_seed(seed)
    u = torch.rand(attr.shape[1], generator=g, device=attr.device)
    sign = torch.where(torch.rand(attr.shape[1], generator=g, device=attr.device) < 0.5,
                       -1.0, 1.0)
    adv = attr.clone()
    adv[5] = torch.where(u < 1 / 3, alpha_min * (1 + 1e-4 * sign), attr[5])
    thin = 0.999 * torch.sqrt(attr[2] * attr[4]) * torch.where(attr[3] < 0, -1.0, 1.0)
    adv[3] = torch.where((u >= 1 / 3) & (u < 1 / 3 + 1 / 4), thin, attr[3])
    return adv


def adversarial_meta(torch, dev, seed):
    """Emission inputs that stress the kernel's edge cases, from a seed:
    [(name, meta, tiles_x, capacity, row0, n_sentinel, total_true)], meta
    the five [N] int32 arrays in emission order. No instance; no Gaussian;
    one Gaussian owning more slots than a block, with the capacity ending
    inside it; a third of the counts zero, two runs of 1e5 zero-count
    Gaussians and Gaussians of 5000 slots, with the capacity ending inside
    the stream; the same as a compacted stream of a row window (row0 17,
    another sentinel id, total_true above the total); a total past
    INT32_MAX; more Gaussians (5M) than the scan has chunks of its
    smallest size. Every tile id fits in int32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32

    def meta(counts, row0=0):
        n = counts.shape[0]
        return (torch.randperm(n, generator=g, device=dev).to(i32), counts.to(i32),
                torch.randint(0, 100, (n,), generator=g, device=dev, dtype=i32),
                torch.randint(row0, row0 + 50, (n,), generator=g, device=dev, dtype=i32),
                torch.randint(1, 9, (n,), generator=g, device=dev, dtype=i32))

    def mixed(n):
        c = torch.randint(0, 6, (n,), generator=g, device=dev)
        c = torch.where(torch.rand(n, generator=g, device=dev) < 1 / 3, 0, c)
        c[1000:101_000] = 0
        c[-100_000:] = 0
        c[150_000:250_000:9973] = 5000
        return c

    c_mix, c_win = mixed(400_000), mixed(300_000)
    c_big = torch.randint(0, 4, (10_000,), generator=g, device=dev)
    c_big[[10, 5000, 9000]] = 2**30
    c_many = torch.randint(0, 3, (5_000_000,), generator=g, device=dev)
    t_mix, t_win, t_many = (int(c.sum()) for c in (c_mix, c_win, c_many))
    zeros = torch.zeros(5000, dtype=i32, device=dev)
    return [
        ("no_instance", meta(zeros), 120, 4096, 0, None, None),
        ("no_gaussian", meta(zeros[:0]), 120, 1024, 0, None, None),
        ("one_gaussian", meta(torch.tensor([3000], device=dev)), 120, 2500, 0, None, None),
        ("mixed", meta(c_mix), 120, t_mix * 9 // 10 + 1, 0, None, None),
        ("compacted_window", meta(c_win, row0=17), 120, t_win * 21 // 20, 17, 400_000,
         torch.tensor(t_win + 999, dtype=torch.int64, device=dev)),
        ("total_past_int32", meta(c_big), 120, 1 << 20, 0, None, None),
        ("many_gaussians", meta(c_many), 120, t_many * 11 // 10, 0, None, None),
    ]


def check_emission_adversarial(torch, dev):
    """The emission kernel against its plain version, bit for bit, on
    :func:`adversarial_meta`. Returns each case's (N, capacity, total)."""
    from tpusplat_torch.ops import binning
    from tpusplat_torch.ops.emission import emit_instances

    out = {}
    for name, meta, tiles_x, cap, row0, n_sentinel, total_true in adversarial_meta(torch, dev,
                                                                                   seed=11):
        args = (*meta, tiles_x, cap, row0, n_sentinel, total_true)
        got, want = emit_instances(*args), binning.expand_instances_sorted(*args)
        for field, a, b in zip(("tile", "gid", "total", "overflow", "gauss_dropped"), got,
                               want):
            check_equal(f"emission ({name}) {field}", a, b)
        out[name] = dict(n=meta[0].shape[0], capacity=cap, total=int(meta[1].long().sum()))
    return out


def adversarial_ids(torch, n, dev, seed):
    """Sorted gradient rows for n Gaussians that stress the segment reduce:
    0-5 rows a Gaussian, a third of the runs empty, one run of 1e5 rows and
    1e5 sentinel rows (id n, NaN) at the end. The values are multiples of
    2^-6 in [-1, 1], so every partial sum is exact in float32 and any order
    of the adds gives the same sums. Returns (rows, gid, bounds)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    counts = torch.randint(0, 6, (n,), generator=g, device=dev)
    counts = torch.where(torch.rand(n, generator=g, device=dev) < 1 / 3, 0, counts)
    counts[n // 2] = 100_000
    ids = torch.arange(n + 1, dtype=torch.int32, device=dev)
    gid = torch.cat([torch.repeat_interleave(ids[:n], counts),
                     torch.full((100_000,), n, dtype=torch.int32, device=dev)])
    rows = torch.randint(-64, 65, (9, gid.shape[0]), generator=g, device=dev) / 64.0
    rows = torch.where(gid[None, :] < n, rows, float("nan"))
    return rows, gid, torch.searchsorted(gid, ids, out_int32=True)


def adversarial_exchange(torch, dev, seed, n=200_000, s=4, cap=40_004):
    """Inputs of both compact-exchange modes that stress their searches:
    (rows, sorted gid, targets, n) of the streamed-target mode and two
    (rows, local ids, n_local) of the multi-range mode. ``cap`` is not a
    multiple of 32, so warps straddle block boundaries. Streamed-target:
    the Gaussians' rows 0-5 each (a third none), a run of 100 rows at n/2
    and 3 rows at n - 1, a tail of 1000 sentinel rows (id n, NaN); the
    targets are S owner blocks of the Gaussians with rows (and every 50th
    without) as ``bucket_targets`` builds them, block 1 wholly of
    sentinels, the id 777 in each of the others. Multi-range: S
    sorted blocks of distinct local ids in [0, n/S), the id 777 in every
    block, a run of 100 rows of one id in block 1, the id n/S - 1 in block
    3, the sentinel n/S at each tail (rows NaN); the second copy has block
    2 wholly of sentinels. Values are multiples of 2^-6 in [-1, 1], so
    every partial sum is exact in float32 and any order of the adds gives
    the same sums."""
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = dict(dtype=torch.int32, device=dev)

    def values(shape, ids, sentinel):
        v = torch.randint(-64, 65, shape, generator=g, device=dev) / 64.0
        return torch.where(ids[None, :] < sentinel, v, float("nan"))

    counts = torch.randint(0, 6, (n,), generator=g, device=dev)
    counts = torch.where(torch.rand(n, generator=g, device=dev) < 1 / 3, 0, counts)
    counts[n // 2], counts[n - 1] = 100, 3
    ids = torch.arange(n, **i32)
    gid = torch.cat([torch.repeat_interleave(ids, counts), torch.full((1000,), n, **i32)])
    stream = (counts > 0) | (ids % 50 == 0)
    per, blocks = n // s, []
    for k in range(s):
        own = ids[k * per:(k + 1) * per][stream[k * per:(k + 1) * per]]
        own = own[:0] if k == 1 else torch.unique(torch.cat([own, ids[777:778]]))
        if own.numel() > cap:
            fail(f"adversarial exchange: owner {k} has {own.numel()} ids, cap {cap}")
        blocks.append(torch.cat([own, torch.full((cap - own.numel(),), n, **i32)]))
    streamed = (values((9, gid.shape[0]), gid, n), gid, torch.cat(blocks), n)

    n_local = per
    lid = torch.full((s, cap), n_local, **i32)
    for b in range(s):
        k = int(torch.randint(cap // 2, cap - 200, (1,), generator=g, device=dev))
        own = torch.randperm(n_local, generator=g, device=dev)[:k].to(torch.int32)
        extra = [ids[777:778], torch.full((100 if b == 1 else 0,), 1234, **i32),
                 torch.full((1 if b == 3 else 0,), n_local - 1, **i32)]
        own = torch.sort(torch.cat([own[(own != 777) & (own != 1234) & (own != n_local - 1)],
                                    *extra])).values
        lid[b, :own.numel()] = own
    lid = lid.reshape(-1)
    lid_empty = lid.view(s, cap).clone()
    lid_empty[2] = n_local
    lid_empty = lid_empty.reshape(-1)
    multirange = [(values((9, s * cap), x, n_local), x, n_local) for x in (lid, lid_empty)]
    return streamed, multirange, s


def check_modes_adversarial(torch, dev):
    """Both compact-exchange modes on :func:`adversarial_exchange`'s blocks:
    each bit-equal to the runs route and to its plain version, and from
    launch to launch; sentinel targets 0."""
    from tpusplat_torch.ops import segment_reduce as sr

    (rows, gid, targets, n), multirange, s = adversarial_exchange(torch, dev, seed=11)
    got = sr.segment_reduce_targets(rows, gid, targets, n)
    m = targets.shape[0]
    check_equal("adversarial streamed-target reduce, runs route", got,
                sr._reduce_ranges(rows, *sr.target_runs(gid, targets, n), 1, m))
    check_equal("adversarial streamed-target reduce, plain", got,
                sr.segment_reduce_targets_plain(rows, gid, targets, n))
    check_equal("adversarial streamed-target reduce, two launches", got,
                sr.segment_reduce_targets(rows, gid, targets, n))
    if bool(got[:, targets >= n].any()):
        fail("adversarial streamed-target reduce: a sentinel target is not 0")
    out = dict(targets=m, sentinel_targets=int((targets >= n).sum()), rows=gid.shape[0])
    for name, (m_rows, lid, n_local) in zip(("repeated_ids", "sentinel_block"), multirange):
        got = sr.segment_reduce_multirange(m_rows, lid, n_local, s)
        check_equal(f"adversarial multi-range reduce ({name}), runs route", got,
                    sr._reduce_ranges(m_rows, *sr.multirange_runs(lid, n_local, s), s, n_local))
        check_equal(f"adversarial multi-range reduce ({name}), plain", got,
                    sr.segment_reduce_multirange_plain(m_rows, lid, n_local))
        check_equal(f"adversarial multi-range reduce ({name}), two launches", got,
                    sr.segment_reduce_multirange(m_rows, lid, n_local, s))
        if not bool(torch.isfinite(got).all()):
            fail(f"adversarial multi-range reduce ({name}): not finite")
        out[name] = dict(live_rows=int((lid < n_local).sum()))
    return out


def phase_parity(torch, dev):
    """BASELINE config 2 (100k, 800x800, SH3): kernels against plain."""
    from tpusplat_torch import RenderConfig, look_at_camera, random_scene
    from tpusplat_torch.ops import binning, rasterize, segment_reduce
    from tpusplat_torch.ops.emission import emit_instances
    from tpusplat_torch.ops.preprocess import ProcessedGaussians, preprocess

    w, h = PARITY["width"], PARITY["height"]
    params = random_scene(PARITY["n"], seed=0, sh_degree=3, scale_range=(0.004, 0.04),
                          extent=4.0, device=dev)
    cam = look_at_camera([0.0, 0.5, 9.0], [0.0, 0.0, 0.0], w, h, fov_deg=60.0, device=dev)
    cfg = RenderConfig(sh_degree=3)
    tiles_x, tiles_y = cfg.tile_grid(w, h)
    n = params.num_gaussians
    cap = cfg.instance_capacity(n)

    pg = preprocess(params, cam, cfg)
    meta = binning.depth_sorted_meta(pg)
    got = emit_instances(*meta, tiles_x, cap, 0, n)
    want = binning.expand_instances_sorted(*meta, tiles_x, cap, 0, n)
    for name, a, b in zip(("tile", "gid", "total", "overflow", "gauss_dropped"), got, want):
        check_equal(f"emission {name}", a, b)
    emission_adv = check_emission_adversarial(torch, dev)

    b_gpu = binning.bin_and_sort(pg, w, h, cfg)
    pg_cpu = ProcessedGaussians(**{f.name: getattr(pg, f.name).cpu()
                                   for f in dataclasses.fields(pg)})
    b_cpu = binning.bin_and_sort(pg_cpu, w, h, cfg)
    for f in dataclasses.fields(b_gpu):
        check_equal(f"bin_and_sort {f.name}", getattr(b_gpu, f.name), getattr(b_cpu, f.name))
    if int(b_gpu.overflow):
        fail("capacity overflow at 100k")
    # Strip compaction (the second of four strips), CUDA against the CPU.
    nrows = -(-tiles_y // 4)
    gcap = cfg.strip_gauss_capacity(n, nrows, tiles_y)
    strips = [binning.bin_and_sort(p, w, h, cfg, nrows, nrows, cap, gauss_capacity=gcap)
              for p in (pg, pg_cpu)]
    if strips[0].stream_ids is None:
        fail("strip compaction not active at 100k")
    for f in dataclasses.fields(strips[0]):
        check_equal(f"compacted bin_and_sort {f.name}", getattr(strips[0], f.name),
                    getattr(strips[1], f.name))

    attr = rasterize.pack_instances(pg, b_gpu)
    max_count = int((b_gpu.tile_end - b_gpu.tile_start).max())
    cfg_p = dataclasses.replace(cfg, max_per_tile=max(cfg.max_per_tile, max_count))
    args = (attr, b_gpu.tile_start, b_gpu.tile_end, tiles_x, 0, w, h, cfg_p)
    img, tmap, _ = rasterize.forward_blend(*args)
    img_p, tmap_p, tovf = rasterize.blend_plain(*args)
    if int(tovf):
        fail("plain blend truncated tiles")
    err_img = check_close("forward image", img, img_p, atol=3e-5, rtol=1e-4)
    err_t = check_close("forward transmittance", tmap, tmap_p, atol=3e-5)

    # Backward kernel against autograd of the plain blend, on the same slab
    # and on seeded cotangents of both outputs.
    d_img, d_tmap = seeded_cotangents(torch, img, tmap, seed=0)
    bw_args = (attr, b_gpu.tile_start, b_gpu.tile_end, img, tmap, d_img, d_tmap, tiles_x, 0,
               w, h, cfg_p)
    d_attr = rasterize.backward_blend(*bw_args)
    d_attr_p = rasterize.backward_blend_plain(*bw_args)
    live = int(b_gpu.num_instances)
    err_bw = check_rows("backward blend", d_attr[:, :live], d_attr_p[:, :live])
    del d_attr_p

    # The same on the adversarial slab, through its own forward.
    adv = adversarial_slab(torch, attr, cfg.alpha_min, seed=4)
    fw_adv = (adv, b_gpu.tile_start, b_gpu.tile_end, tiles_x, 0, w, h, cfg_p)
    img_a, tmap_a, _ = rasterize.forward_blend(*fw_adv)
    img_ap, tmap_ap, _ = rasterize.blend_plain(*fw_adv)
    err_fw_adv = max(check_close("forward image (adversarial slab)", img_a, img_ap, atol=3e-5,
                                 rtol=1e-4),
                     check_close("forward transmittance (adversarial slab)", tmap_a, tmap_ap,
                                 atol=3e-5))
    del img_ap, tmap_ap
    bw_adv = (adv, b_gpu.tile_start, b_gpu.tile_end, img_a, tmap_a, d_img, d_tmap, tiles_x,
              0, w, h, cfg_p)
    err_adv = check_rows("backward blend (adversarial slab)",
                         rasterize.backward_blend(*bw_adv)[:, :live],
                         rasterize.backward_blend_plain(*bw_adv)[:, :live])
    err_rows = {f"{tw}x{th}": blend_row_major(torch, params, cam, cfg, tw, th)
                for tw, th in ROW_MAJOR_TILES}

    # Segment reduce against index_add_, on the real ids with standard-normal
    # rows and NaN in the sentinel slots.
    rows, gid_s, bounds = rasterize.sort_grad_rows(
        random_rows(torch, b_gpu.gauss_id, n, seed=1), b_gpu.gauss_id, n)
    seg = segment_reduce.segment_reduce(rows, gid_s, bounds)
    seg_p = segment_reduce.segment_reduce_plain(rows, gid_s, bounds)
    err_seg = check_close("segment reduce", seg, seg_p, atol=1e-4)
    log(phase="parity_100k", n=n, width=w, height=h, capacity=cap, num_instances=live,
        max_tile_count=max_count, emission="bit-equal",
        emission_adversarial=dict(result="bit-equal", cases=emission_adv),
        bin_and_sort="bit-equal vs CPU",
        compacted_strip=dict(gauss_capacity=gcap,
                             gauss_overflow=int(strips[0].gauss_overflow)),
        forward_max_abs_err_image=err_img, forward_max_abs_err_transmittance=err_t,
        forward_adversarial_max_abs_err=err_fw_adv, backward_max_norm_err=err_bw,
        backward_adversarial_max_norm_err=err_adv,
        row_major_max_err=dict(forward_abs={k: v[0] for k, v in err_rows.items()},
                               backward_norm={k: v[1] for k, v in err_rows.items()}),
        segment_reduce_max_abs_err=err_seg)


def blend_row_major(torch, params, cam, cfg, tile_w, tile_h):
    """The forward and backward kernels against their plain versions on
    tiles that do not split into 8 x 4 warps, where their warps are 32
    consecutive pixels (the row-major layout of csrc/cull.cuh) and their
    cull tests those rectangles. Returns the forward's largest absolute
    error and the backward's largest normalised error."""
    from tpusplat_torch.ops import binning, rasterize
    from tpusplat_torch.ops.preprocess import preprocess

    w, h = cam.width, cam.height
    cfg = dataclasses.replace(cfg, tile_w=tile_w, tile_h=tile_h)
    pg = preprocess(params, cam, cfg)
    cfg = dataclasses.replace(cfg, capacity=int(pg.ntiles.sum()))
    binned = binning.bin_and_sort(pg, w, h, cfg)
    if int(binned.overflow):
        fail(f"capacity overflow at 100k, {tile_w}x{tile_h} tiles")
    attr = rasterize.pack_instances(pg, binned)
    starts, ends = binned.tile_start, binned.tile_end
    cfg = dataclasses.replace(cfg, max_per_tile=max(cfg.max_per_tile,
                                                    int((ends - starts).max())))
    tiles_x, _ = cfg.tile_grid(w, h)
    fw_args = (attr, starts, ends, tiles_x, 0, w, h, cfg)
    img, tmap, _ = rasterize.forward_blend(*fw_args)
    img_p, tmap_p, _ = rasterize.blend_plain(*fw_args)
    err_fw = max(check_close(f"forward image ({tile_w}x{tile_h} tiles)", img, img_p, atol=3e-5,
                             rtol=1e-4),
                 check_close(f"forward transmittance ({tile_w}x{tile_h} tiles)", tmap, tmap_p,
                             atol=3e-5))
    del img_p, tmap_p
    d_img, d_tmap = seeded_cotangents(torch, img, tmap, seed=6)
    args = (attr, starts, ends, img, tmap, d_img, d_tmap, tiles_x, 0, w, h, cfg)
    live = int(binned.num_instances)
    return err_fw, check_rows(f"backward blend ({tile_w}x{tile_h} tiles)",
                              rasterize.backward_blend(*args)[:, :live],
                              rasterize.backward_blend_plain(*args)[:, :live])


def loss_and_grads(torch, params, cam, target, cfg):
    """gs_loss of the render plus 0.1 mean(T), and its gradient with respect
    to the five trainable tensors."""
    from tpusplat_torch.render import render_stages
    from tpusplat_torch.train.losses import gs_loss

    leaves = {f: getattr(params, f).detach().clone().requires_grad_(True) for f in GRAD_FIELDS}
    img, aux = render_stages(dataclasses.replace(params, **leaves), cam, cfg)
    if int(aux["capacity_overflow"]) or int(aux["tile_overflow"]):
        fail("grad_6k: the render overflowed")
    loss = gs_loss(img, target) + 0.1 * aux["transmittance"].mean()
    grads = torch.autograd.grad(loss, [leaves[f] for f in GRAD_FIELDS])
    return float(loss.detach()), dict(zip(GRAD_FIELDS, grads))


def phase_grad_6k(torch, dev):
    """Five parameter gradients, CUDA pipeline against the CPU plain one."""
    from tpusplat_torch import RenderConfig, look_at_camera, random_scene
    from tpusplat_torch.ops import rasterize, segment_reduce

    w, h = GRAD["width"], GRAD["height"]
    cfg = RenderConfig(sh_degree=3)
    target = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(0))
    out = []
    for d in (dev, torch.device("cpu")):
        params = random_scene(GRAD["n"], seed=1, sh_degree=3, scale_range=(0.004, 0.04),
                              extent=4.0, device=d)
        cam = look_at_camera([0.0, 0.5, 9.0], [0.0, 0.0, 0.0], w, h, fov_deg=60.0, device=d)
        before = (rasterize.BACKWARD_LAUNCHES, segment_reduce.LAUNCHES)
        out.append(loss_and_grads(torch, params, cam, target.to(d), cfg))
        after = (rasterize.BACKWARD_LAUNCHES, segment_reduce.LAUNCHES)
        if d == dev and not all(a > b for a, b in zip(after, before)):
            fail("grad_6k: the backward kernels were not launched")
    (loss_g, g_gpu), (loss_c, g_cpu) = out
    errs = {f: check_rows(f"grad_6k {f}", g_gpu[f].cpu().reshape(1, -1),
                          g_cpu[f].reshape(1, -1)) for f in GRAD_FIELDS}
    log(phase="grad_6k", n=GRAD["n"], width=w, height=h, sh_degree=3, loss_cuda=loss_g,
        loss_cpu=loss_c, max_norm_err=errs)


def phase_garden_serving(torch, dev, params, cams, cfg):
    """render_auto on the orbit, the serving path's counters around it."""
    from tpusplat_torch.ops import emission, rasterize
    from tpusplat_torch.render import render_auto, render_profiled

    w, h = cams[0].width, cams[0].height
    render_auto(params, cams[0], cfg)  # warm-up frame
    torch.cuda.synchronize()
    emission.LAUNCHES = 0
    rasterize.FORWARD_LAUNCHES = 0
    frames_ms, instances = [], []
    for i, cam in enumerate(cams):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        before = (emission.LAUNCHES, rasterize.FORWARD_LAUNCHES)
        e0.record()
        img, aux, cfg = render_auto(params, cam, cfg)
        e1.record()
        e1.synchronize()
        frames_ms.append(e0.elapsed_time(e1))
        instances.append(int(aux["num_instances"]))
        if int(aux["capacity_overflow"]) != 0:
            fail(f"garden frame {i}: capacity overflow")
        if emission.LAUNCHES <= before[0] or rasterize.FORWARD_LAUNCHES <= before[1]:
            fail(f"garden frame {i}: a kernel was not launched")
        if img.shape != (h, w, 3) or not bool(torch.isfinite(img).all()):
            fail(f"garden frame {i}: image not finite or of the wrong shape")
        if float(img.max()) <= 0.0:
            fail(f"garden frame {i}: image all black")
    launches = dict(emission=emission.LAUNCHES, forward_blend=rasterize.FORWARD_LAUNCHES)
    _, _, stage_ms = render_profiled(params, cams[0], cfg)
    log(phase="garden_serving", n=params.num_gaussians, width=w, height=h,
        capacity=cfg.instance_capacity(params.num_gaussians), frames_ms=frames_ms,
        num_instances=instances, stage_ms=stage_ms, launches=launches)
    return cfg, launches


def phase_garden_training(torch, dev, params, cams, cfg):
    """Three train_steps at the garden shapes through all four kernels."""
    from tpusplat_torch import random_scene
    from tpusplat_torch.config import regrow
    from tpusplat_torch.ops import emission, rasterize, segment_reduce
    from tpusplat_torch.render import render_auto
    from tpusplat_torch.train import step as tstep

    n = params.num_gaussians
    w, h = cams[0].width, cams[0].height
    with torch.no_grad():
        gt = random_scene(n, seed=1, sh_degree=3, scale_range=(0.002, 0.02), extent=4.0,
                          device=dev)
        targets = [render_auto(gt, cam, cfg)[0] for cam in cams]
        del gt
    opt = tstep.make_optimizer(scene_extent=4.0)
    state0 = tstep.create_train_state(params)
    tstep.train_step(state0, cams[0], targets[0], cfg, opt)  # warm-up, discarded
    torch.cuda.synchronize()

    counters = (lambda: (emission.LAUNCHES, rasterize.FORWARD_LAUNCHES,
                         rasterize.BACKWARD_LAUNCHES, segment_reduce.LAUNCHES))
    emission.LAUNCHES = rasterize.FORWARD_LAUNCHES = 0
    rasterize.BACKWARD_LAUNCHES = segment_reduce.LAUNCHES = 0
    state, steps_ms, losses, retries, device_allocs = state0, [], [], 0, []
    torch.cuda.reset_peak_memory_stats()
    for i, cam in enumerate(cams):
        for _ in range(5):
            before = counters()
            allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            new, metrics = tstep.train_step(state, cam, targets[i], cfg, opt)
            e1.record()
            e1.synchronize()
            if not all(a > b for a, b in zip(counters(), before)):
                fail(f"garden step {i}: a kernel was not launched ({counters()})")
            cfg2, changes = regrow(cfg, metrics, n)
            if changes is None:
                break
            if int(new.step) != int(state.step) or not torch.equal(new.params.means,
                                                                   state.params.means):
                fail(f"garden step {i}: an overflowed step changed the state")
            cfg, retries = cfg2, retries + 1
        else:
            fail(f"garden step {i}: still overflowing after 5 tries")
        state = new
        steps_ms.append(e0.elapsed_time(e1))
        # cudaMalloc calls the caching allocator made during the step
        device_allocs.append(torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs)
        losses.append(float(metrics["loss"]))
    launches = dict(zip(("emission", "forward_blend", "backward_blend", "segment_reduce"),
                        counters()))
    if not all(math.isfinite(v) for v in losses):
        fail(f"garden training: loss not finite {losses}")
    if int(state.step) != len(cams):
        fail(f"garden training: step {int(state.step)}, expected {len(cams)}")
    if torch.equal(state.params.means, params.means) or \
            torch.equal(state.params.opacities, params.opacities):
        fail("garden training: the parameters did not change")

    # One more step, split into forward (render + loss), backward and Adam.
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    marks[0].record()
    loss, aux, leaves = tstep.step_forward(state, cams[0], targets[0], cfg)
    marks[1].record()
    grads = tstep.step_backward(loss, leaves)
    marks[2].record()
    tstep.apply_gradients(state, loss, aux, grads, opt)
    marks[3].record()
    marks[3].synchronize()
    split_ms = dict(zip(("forward", "backward", "adam"),
                        (a.elapsed_time(b) for a, b in zip(marks, marks[1:]))))
    mean_ms = sum(steps_ms) / len(steps_ms)
    log(phase="garden_training", n=n, width=w, height=h, sh_degree=3,
        capacity=cfg.instance_capacity(n), steps_ms=steps_ms, losses=losses, retries=retries,
        step=int(state.step), launches=launches, split_ms=split_ms,
        device_allocs=device_allocs, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        mpix_per_s=w * h / (mean_ms * 1e-3) / 1e6)
    return cfg, launches


def phase_kernels(torch, dev, params, cam, cfg, label="garden"):
    """Each kernel against its plain version at the shapes of the scene
    ``label`` names (garden in the main run, bicycle in the headline
    phase), timed; logged as the phase ``kernels_<label>``."""
    from tpusplat_torch.ops import binning, emission, rasterize, segment_reduce
    from tpusplat_torch.ops.preprocess import preprocess

    t0 = time.perf_counter()
    n = params.num_gaussians
    w, h = cam.width, cam.height
    tiles_x, tiles_y = cfg.tile_grid(w, h)
    cap = cfg.instance_capacity(n)
    out = {}
    with torch.no_grad():
        pg = preprocess(params, cam, cfg)
        meta = binning.depth_sorted_meta(pg)
        em_args = (*meta, tiles_x, cap, 0, n)
        got = emission.emit_instances(*em_args)
        want = binning.expand_instances_sorted(*em_args)
        for name, a, b in zip(("tile", "gid", "total", "overflow"), got, want):
            check_equal(f"{label} emission {name}", a, b)
        bufs = emission.output_buffers(n, cap, dev)
        out["emission"] = dict(
            max_abs_err=max(float((a.long() - b.long()).abs().max())
                            for a, b in zip(got[:2], want[:2])),
            ms=cuda_ms(torch, lambda: emission.emit_instances(*em_args), reps=100),
            ms_is="the wrapper's calls back to back; a launch is one C call, which runs "
                  "the kernel's two parts (the scan, then the emission)",
            kernel_ms=cuda_ms(torch, lambda: emission.launch(*meta, tiles_x, cap, 0, n, None,
                                                             bufs), reps=100),
            plain_ms=cuda_ms(torch, lambda: binning.expand_instances_sorted(*em_args), reps=5),
            library_ms=None,
            # five [N] int32 meta in, two [C] int32 out; its work is integer
            # work (a scan of the counts, an owner search and a division per
            # slot), for which the peak table has no rate: the bytes bound it.
            bound=bound(4 * (5 * n + 2 * cap), 0))

        binned = binning.bin_and_sort(pg, w, h, cfg)
        attr = rasterize.pack_instances(pg, binned)
        starts, ends = binned.tile_start, binned.tile_end
        live = int(binned.num_instances)
        max_count = int((ends - starts).max())
        cfg_p = dataclasses.replace(cfg, max_per_tile=max(cfg.max_per_tile, max_count))
        fw_args = (attr, starts, ends, tiles_x, 0, w, h, cfg_p)
        img, tmap, _ = rasterize.forward_blend(*fw_args)
        img_p, tmap_p, _ = rasterize.blend_plain(*fw_args)
        npx = cfg.tile_w * cfg.tile_h
        # (instance, warp) pairs of both blend walks, and how many the cull
        # skips (the forward and the backward kernel cull alike); the pairs
        # the walk must take, and the (instance, pixel) pairs of both
        # kernels' bounds.
        pairs_iw, culled_iw = cull_counts(torch, attr[:, :live], binned.tile_id[:live],
                                          tiles_x, 0, cfg)
        visited, passing, contrib, live_iw, walked_iw = pair_counts(
            torch, attr, starts, ends, tiles_x, 0, w, h, cfg_p)
        slab_bytes = 4 * (9 * live + 2 * tiles_x * tiles_y + 4 * w * h)
        out["forward_blend"] = dict(
            cull=dict(instance_warp_pairs=pairs_iw, culled=culled_iw,
                      culled_share=culled_iw / max(pairs_iw, 1), needed=walked_iw),
            max_abs_err=max(check_close(f"{label} forward image", img, img_p, atol=3e-5,
                                        rtol=1e-4),
                            check_close(f"{label} forward transmittance", tmap, tmap_p,
                                        atol=3e-5)),
            ms=cuda_ms(torch, lambda: rasterize.forward_blend(*fw_args), reps=20),
            plain_ms=cuda_ms(torch, lambda: rasterize.blend_plain(*fw_args), reps=2),
            library_ms=None,
            # slab, tile ranges, img and T; the test's operations on the 32
            # pixels of each (instance, warp) pair the walk must take
            bound=bound(slab_bytes, walked_iw * 32 * BLEND_FLOPS_PER_PAIR),
            # every (instance, pixel) pair of a walk without the cull, the
            # measure of the bound before the cull reached the forward
            bound_unculled_ms=bound(slab_bytes, live * npx * BLEND_FLOPS_PER_PAIR)[0])
        del img_p, tmap_p

        # Backward blend: the kernel on the full frame; against its plain
        # version (autograd of the plain blend) on a strip of 4 tile rows
        # through the middle of the image, where the full frame's autograd
        # would not fit.
        d_img, d_tmap = seeded_cotangents(torch, img, tmap, seed=2)
        bw_args = (attr, starts, ends, img, tmap, d_img, d_tmap, tiles_x, 0, w, h, cfg_p)
        d_attr = rasterize.backward_blend(*bw_args)
        check_equal(f"{label} backward blend, two launches", d_attr[:, :live],
                    rasterize.backward_blend(*bw_args)[:, :live])
        r0, nr = tiles_y // 2 - 2, 4
        tsl = slice(r0 * tiles_x, (r0 + nr) * tiles_x)
        psl = slice(r0 * cfg.tile_h, (r0 + nr) * cfg.tile_h)
        st_args = (attr, starts[tsl], ends[tsl], img[psl], tmap[psl], d_img[psl], d_tmap[psl],
                   tiles_x, r0, w, nr * cfg.tile_h, cfg_p)
        lo, hi = int(starts[tsl][0]), int(ends[tsl][-1])
        d_strip = rasterize.backward_blend(*st_args)
        d_strip_p = rasterize.backward_blend_plain(*st_args)
        out["backward_blend"] = dict(
            max_abs_err=check_rows(f"{label} backward blend (strip)", d_strip[:, lo:hi],
                                   d_strip_p[:, lo:hi]),
            max_err_is="normalised by each row's largest magnitude",
            ms=cuda_ms(torch, lambda: rasterize.backward_blend(*bw_args), reps=20),
            strip=dict(tile_rows=[r0, r0 + nr], instances=hi - lo,
                       ms=cuda_ms(torch, lambda: rasterize.backward_blend(*st_args), reps=20)),
            plain_ms=cuda_ms(torch, lambda: rasterize.backward_blend_plain(*st_args), reps=2),
            plain_scope=f"strip of tile rows {r0}..{r0 + nr - 1} ({hi - lo} instances)",
            library_ms=None, pairs=dict(visited=visited, passing=passing,
                                        contributing=contrib),
            cull=dict(instance_warp_pairs=pairs_iw, culled=culled_iw,
                      culled_share=culled_iw / max(pairs_iw, 1), live=live_iw,
                      needed=walked_iw, walked_dead=pairs_iw - culled_iw - live_iw),
            # slab in and out, tile ranges, img, T and both cotangents; the
            # test on the walked (instance, warp) pairs, as in the forward
            bound=bound(4 * (18 * live + 2 * tiles_x * tiles_y + 8 * w * h),
                        walked_iw * 32 * BLEND_FLOPS_PER_PAIR
                        + passing * BACKWARD_FLOPS_PER_PASSING_PAIR
                        + contrib * BACKWARD_FLOPS_PER_CONTRIB_PAIR))
        del d_strip, d_strip_p

        # Segment reduce on the real gradient ids, and the same reduce as one
        # index_add_ call (the library yardstick, never used by the port).
        rows, gid_s, bounds = rasterize.sort_grad_rows(d_attr, binned.gauss_id, n)
        r_rows, _, _ = rasterize.sort_grad_rows(random_rows(torch, binned.gauss_id, n, seed=3),
                                                binned.gauss_id, n)
        seg_err = check_close(f"{label} segment reduce",
                              segment_reduce.segment_reduce(r_rows, gid_s, bounds),
                              segment_reduce.segment_reduce_plain(r_rows, gid_s, bounds),
                              atol=1e-4)
        check_equal(f"{label} segment reduce, two launches",
                    segment_reduce.segment_reduce(rows, gid_s, bounds),
                    segment_reduce.segment_reduce(rows, gid_s, bounds))
        a_rows, a_gid, a_bounds = adversarial_ids(torch, n, dev, seed=5)
        a_err = check_close(f"{label} segment reduce (adversarial ids)",
                            segment_reduce.segment_reduce(a_rows, a_gid, a_bounds),
                            segment_reduce.segment_reduce_plain(a_rows, a_gid, a_bounds),
                            atol=1e-4)
        del a_rows, a_gid, a_bounds
        runs = (bounds[1:] - bounds[:-1]).float()
        keep = gid_s < n
        k_ids, k_rows = gid_s[keep].long(), rows[:, keep].contiguous()
        out["segment_reduce"] = dict(
            max_abs_err=seg_err, adversarial_max_abs_err=a_err,
            run_lengths=dict(mean=float(runs.mean()),
                             p99=float(torch.quantile(runs, 0.99)), max=int(runs.max())),
            ms=cuda_ms(torch, lambda: segment_reduce.segment_reduce(rows, gid_s, bounds),
                       reps=20),
            plain_ms=cuda_ms(torch, lambda: segment_reduce.segment_reduce_plain(
                rows, gid_s, bounds), reps=5),
            library_ms=cuda_ms(torch, lambda: torch.zeros((9, n), device=dev).index_add_(
                1, k_ids, k_rows), reps=20),
            gather_grad_ms=cuda_ms(torch, lambda: rasterize.gather_grad(
                d_attr, binned.gauss_id, n), reps=20),
            # 9 values per live row (the ids are not read), the bounds; 9 sums
            # per Gaussian
            bound=bound(4 * (9 * live + (n + 1) + 9 * n), 9 * live))
    for v in out.values():
        v["bound_ms"], v["bound_by"] = v.pop("bound")
    # The timing loops' launches count on no path.
    emission.LAUNCHES = rasterize.FORWARD_LAUNCHES = rasterize.BACKWARD_LAUNCHES = 0
    segment_reduce.LAUNCHES = 0
    log(phase=f"kernels_{label}", seconds=time.perf_counter() - t0, num_instances=live,
        max_tile_count=max_count, kernels=out)
    return out


def phase_sharded_emulated(torch, dev, params, cam, cfg):
    """One garden strip of the tile-sharded path through the compact
    exchange's one-process emulation, and its two reduce modes timed."""
    from tpusplat_torch.ops import binning, emission, rasterize
    from tpusplat_torch.ops import segment_reduce as sr
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.parallel import compact_grad as cg
    from tpusplat_torch.parallel.sharded import strip_geometry

    n = params.num_gaussians
    w, h = cam.width, cam.height
    cfg = dataclasses.replace(cfg, strip_gauss_mult=SHARDED_GAUSS_MULT, capacity=None)
    tiles_x, tiles_y = cfg.tile_grid(w, h)
    nrows, cap_shard = strip_geometry(n // SHARDED_TILE, h, cfg, SHARDED_TILE)
    row0 = SHARDED_STRIP * nrows
    gcap = cfg.strip_gauss_capacity(n, nrows, tiles_y)
    if gcap is None or gcap >= n or nrows >= tiles_y:
        fail(f"sharded_emulated: strip compaction is not active (cap {gcap}, N {n})")
    with torch.no_grad():
        pg = preprocess(params, cam, cfg)
        visible = int(binning.strip_visible(pg, row0, nrows).sum())
        st = cg.CompactStatic(cfg=cfg, width=w, height=h, nrows=nrows,
                              cap_shard=cap_shard, gcap=gcap,
                              n_total=n, n_local=n // SHARDED_TILE, n_shards=SHARDED_TILE)
        table = cg.pack_exchange_table(pg)[None]
    crop_h = nrows * cfg.tile_h
    g = torch.Generator(device=dev).manual_seed(8)
    cot = torch.randn((1, crop_h, w, 3), generator=g, device=dev)

    # The path, its launch counters reset just before and read just after.
    table_in = table.clone().requires_grad_(True)
    torch.cuda.synchronize()
    emission.LAUNCHES = rasterize.FORWARD_LAUNCHES = rasterize.BACKWARD_LAUNCHES = 0
    sr.LAUNCHES = sr.TARGETS_LAUNCHES = sr.MULTIRANGE_LAUNCHES = 0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    img, counters = cg.exchange_render_emulated(table_in, st, row0)
    (d_table,) = torch.autograd.grad((img * cot).sum(), table_in)
    e1.record()
    e1.synchronize()
    launches = dict(emission=emission.LAUNCHES, forward_blend=rasterize.FORWARD_LAUNCHES,
                    backward_blend=rasterize.BACKWARD_LAUNCHES,
                    segment_reduce_targets=sr.TARGETS_LAUNCHES,
                    segment_reduce_multirange=sr.MULTIRANGE_LAUNCHES)
    if not all(launches.values()):
        fail(f"sharded_emulated: a kernel of the path was not launched ({launches})")
    counters = dict(zip(("capacity_overflow", "tile_overflow", "gauss_overflow",
                         "a2a_overflow"), counters[0].tolist()))
    if counters["capacity_overflow"] or not bool(torch.isfinite(img).all()) \
            or not bool(torch.isfinite(d_table).all()) or float(img.max()) <= 0:
        fail(f"sharded_emulated: strip not finite, black or overflowed ({counters})")

    # The same strip, stage by stage: the inputs of the two reduce modes.
    with torch.no_grad():
        tbl = table[0]
        _, _, res = cg.strip_forward(tbl, row0, st)
        attr, gid, starts, ends, simg, tmap, stream_ids = res
        # The forward on the strip, whose warp rectangles lie in global
        # pixel rows (row0 > 0), against its plain version.
        cfg_s = dataclasses.replace(cfg, max_per_tile=max(cfg.max_per_tile,
                                                          int((ends - starts).max())))
        fw_args = (attr, starts, ends, tiles_x, row0, w, crop_h, cfg_s)
        f_img, f_t, _ = rasterize.forward_blend(*fw_args)
        p_img, p_t, _ = rasterize.blend_plain(*fw_args)
        err_f = max(check_close("strip forward image", f_img, p_img, atol=3e-5, rtol=1e-4),
                    check_close("strip forward transmittance", f_t, p_t, atol=3e-5))
        del f_img, f_t, p_img, p_t
        d_attr = rasterize.backward_blend(attr, starts, ends, simg, tmap, cot[0].contiguous(),
                                          torch.zeros_like(tmap), tiles_x, row0, w, crop_h, cfg)
        rows, gid_s = cg.sort_by_id(d_attr, gid)
        targets = cg.bucket_targets(stream_ids, st)
        k0 = torch.arange(SHARDED_TILE, dtype=torch.int32, device=dev) * st.n_local
        lid = cg.owner_local_ids(targets, k0, st)
        r_rows, _ = cg.sort_by_id(random_rows(torch, gid, n, seed=9), gid)
        live = int((gid_s < n).sum())
        live_x = int((lid < st.n_local).sum())
        m, n_loc = targets.shape[0], st.n_local

        # The runs route: the dense kernel over the runs torch.searchsorted
        # finds, the statement of which rows each output sums and in what
        # order; each mode must match it bit for bit.
        def runs_targets(r):
            return sr._reduce_ranges(r, *sr.target_runs(gid_s, targets, n), 1, m)

        def runs_multirange(g_rows):
            return sr._reduce_ranges(g_rows, *sr.multirange_runs(lid, n_loc, SHARDED_TILE),
                                     SHARDED_TILE, n_loc)

        g_red = sr.segment_reduce_targets(rows, gid_s, targets, n)
        r_red = sr.segment_reduce_targets(r_rows, gid_s, targets, n)
        check_equal("streamed-target reduce, runs route (strip rows)", g_red, runs_targets(rows))
        check_equal("streamed-target reduce, runs route (random rows)", r_red,
                    runs_targets(r_rows))
        check_equal("streamed-target reduce, two launches", g_red,
                    sr.segment_reduce_targets(rows, gid_s, targets, n))
        err_t = check_close("streamed-target reduce", r_red,
                            sr.segment_reduce_targets_plain(r_rows, gid_s, targets, n), atol=1e-4)
        dense = sr.segment_reduce_multirange(g_red, lid, n_loc, SHARDED_TILE)
        r_dense = sr.segment_reduce_multirange(r_red, lid, n_loc, SHARDED_TILE)
        check_equal("multi-range reduce, runs route (strip rows)", dense, runs_multirange(g_red))
        check_equal("multi-range reduce, runs route (random rows)", r_dense,
                    runs_multirange(r_red))
        check_equal("multi-range reduce, two launches", dense,
                    sr.segment_reduce_multirange(g_red, lid, n_loc, SHARDED_TILE))
        err_m = check_close("multi-range reduce", r_dense,
                            sr.segment_reduce_multirange_plain(r_red, lid, n_loc), atol=1e-4)
        adversarial = check_modes_adversarial(torch, dev)

        # The library yardstick of the multi-range mode, never used by the
        # port: one index_add_ into n_local + 1 columns, the sentinel's last
        # (its 860k sentinel rows all add into that one column); and one of
        # the live rows alone, picked beforehand, as the dense mode's
        # yardstick is.
        lid_l = torch.clamp_max(lid, n_loc).long()
        keep = lid < n_loc
        k_lid, k_rows = lid[keep].long(), g_red[:, keep].contiguous()

        def library_multirange():
            return torch.zeros((9, n_loc + 1), device=dev).index_add_(1, lid_l, g_red)[:, :n_loc]

        def library_live():
            return torch.zeros((9, n_loc), device=dev).index_add_(1, k_lid, k_rows)

        check_close("multi-range reduce, index_add_", library_multirange(), dense, atol=1e-4)
        check_close("multi-range reduce, index_add_ of the live rows", library_live(), dense,
                    atol=1e-4)
        out_t = torch.empty((9, m), device=dev)
        out_m = torch.empty((9, n_loc), device=dev)
        out = {}
        # Each mode in turns with the runs route: route, wrapper, wrapper,
        # route; the C call alone on buffers made beforehand.
        route_t = [cuda_ms(torch, lambda: runs_targets(rows), reps=20)]
        wrapper_t = [cuda_ms(torch, lambda: sr.segment_reduce_targets(rows, gid_s, targets, n),
                             reps=20) for _ in range(2)]
        route_t.append(cuda_ms(torch, lambda: runs_targets(rows), reps=20))
        out["segment_reduce_targets"] = dict(
            max_abs_err=err_t, ms=statistics.median(wrapper_t), wrapper_ms=wrapper_t,
            ms_is="the wrapper's calls back to back (the median of two readings); a launch is one C "
                  "call, which searches the runs and sums them",
            kernel_ms=cuda_ms(torch, lambda: sr.launch_targets(rows, gid_s, targets, n, out_t),
                              reps=20),
            runs_route_ms=route_t,
            plain_ms=cuda_ms(torch, lambda: sr.segment_reduce_targets_plain(
                rows, gid_s, targets, n), reps=5),
            library_ms=None,
            library_is="none: no single PyTorch call sums a sorted slab's rows per target",
            # 9 values per live row, the targets; 9 sums per target
            bound=bound(4 * (9 * live + m + 9 * m), 9 * live))
        route_m = [cuda_ms(torch, lambda: runs_multirange(g_red), reps=20)]
        wrapper_m = [cuda_ms(torch, lambda: sr.segment_reduce_multirange(
            g_red, lid, n_loc, SHARDED_TILE), reps=20) for _ in range(2)]
        route_m.append(cuda_ms(torch, lambda: runs_multirange(g_red), reps=20))
        out["segment_reduce_multirange"] = dict(
            max_abs_err=err_m, ms=statistics.median(wrapper_m), wrapper_ms=wrapper_m,
            ms_is="the wrapper's calls back to back (the median of two readings); a launch is one C "
                  "call, which searches the runs and sums them",
            kernel_ms=cuda_ms(torch, lambda: sr.launch_multirange(
                g_red, lid, n_loc, SHARDED_TILE, out_m), reps=20),
            runs_route_ms=route_m,
            plain_ms=cuda_ms(torch, lambda: sr.segment_reduce_multirange_plain(
                g_red, lid, n_loc), reps=5),
            library_ms=cuda_ms(torch, library_multirange, reps=20),
            library_is="torch.zeros + index_add_ of all S x cap rows into n_local + 1 columns",
            library_live_ms=cuda_ms(torch, library_live, reps=20),
            # 9 values and the id per live row; 9 sums per local Gaussian. A
            # block's sentinel tail is found by a search and never read.
            bound=bound(4 * (9 * live_x + live_x + 9 * n_loc), 9 * live_x))
        for v in out.values():
            v["bound_ms"], v["bound_by"] = v.pop("bound")

        split = dict(
            binning=cuda_ms(torch, lambda: binning.bin_and_sort(
                cg.pg_from_table(tbl), w, h, cfg, row0, nrows, st.cap_shard,
                gauss_capacity=gcap), reps=5),
            forward_kernel=cuda_ms(torch, lambda: rasterize.forward_blend(
                attr, starts, ends, tiles_x, row0, w, crop_h, cfg), reps=5),
            backward_kernel=cuda_ms(torch, lambda: rasterize.backward_blend(
                attr, starts, ends, simg, tmap, cot[0].contiguous(), torch.zeros_like(tmap),
                tiles_x, row0, w, crop_h, cfg), reps=5),
            gid_sort=cuda_ms(torch, lambda: cg.sort_by_id(d_attr, gid), reps=5),
            bucket_targets=cuda_ms(torch, lambda: cg.bucket_targets(stream_ids, st), reps=5),
            reduce=cuda_ms(torch, lambda: sr.segment_reduce_targets(
                rows, gid_s, targets, n), reps=5),
            owner_local_ids=cuda_ms(torch, lambda: cg.owner_local_ids(targets, k0, st), reps=5),
            owner_reduce=cuda_ms(torch, lambda: sr.segment_reduce_multirange(
                g_red, lid, n_loc, SHARDED_TILE), reps=5))
    # The timing loops' launches count on no path.
    sr.TARGETS_LAUNCHES = sr.MULTIRANGE_LAUNCHES = 0
    log(phase="sharded_emulated", n=n, width=w, height=h, tile_shards=SHARDED_TILE,
        strip_rows=[row0, row0 + nrows], compaction=dict(active=True, gauss_capacity=gcap,
                                                         strip_visible=visible),
        capacity=st.cap_shard, num_instances=live, bucket_cap=cg.a2a_bucket_cap(st),
        targets=m, owner_rows=live_x, counters=counters, path_ms=e0.elapsed_time(e1),
        launches=launches, split_ms=split, forward_max_abs_err=err_f,
        adversarial=adversarial,
        kernels={k: {kk: vv for kk, vv in v.items()} for k, v in out.items()})
    for k in out:
        out[k]["launches"] = launches[k]
    return out


def one_process_step(state, cams, targets, cfg, opt):
    """The one-process reference of a sharded step on a camera batch: each
    camera's loss and gradients through ``train_step``'s pieces, their
    means, then its gated Adam update (``train_step`` itself for one
    camera)."""
    from tpusplat_torch.train import step as tstep

    losses, grads = [], []
    for cam, tgt in zip(cams, targets):
        loss, aux, leaves = tstep.step_forward(state, cam, tgt, cfg)
        losses.append(loss.detach())
        grads.append(tstep.step_backward(loss, leaves))
    mean = {k: sum(g[k] for g in grads) / len(grads) for k in grads[0]}
    return tstep.apply_gradients(state, sum(losses) / len(losses), aux, mean, opt)


def state_errors(got, want):
    """Max abs error of each parameter field, and of each Adam moment
    normalised by the wanted moment's largest magnitude (after one step
    mu = 0.1 g and nu = 0.001 g^2: the gradient's magnitude, which the first
    update, -lr sign(g), does not show)."""
    out = dict(params={f: float((getattr(got.params, f) - getattr(want.params, f)).abs().max())
                       for f in GRAD_FIELDS})
    for m in ("mu", "nu"):
        out[m] = {f: float((getattr(got, m)[f] - getattr(want, m)[f]).abs().max()
                           / getattr(want, m)[f].abs().max()) for f in GRAD_FIELDS}
    return out


def check_state_errors(what, errors, param_atol, moment_tol, fields=GRAD_FIELDS):
    """Fail unless the parameters of ``fields`` are within ``param_atol``
    and every moment within ``moment_tol`` (:func:`state_errors`)."""
    for group, tol, names in (("params", param_atol, fields), ("mu", moment_tol, GRAD_FIELDS),
                              ("nu", moment_tol, GRAD_FIELDS)):
        for f in names:
            if not errors[group][f] <= tol:
                fail(f"{what}: {group} {f} off by {errors[group][f]} (bound {tol})")


SHARDED_STEPS = ("dense", "compact", "overlap", "overlap_psum")


def _multi_process_worker(rank, dev, out_dir, meshes, scene):
    """One rank of a multi-process phase: for each mesh, the sharded steps
    of ``SHARDED_STEPS`` from one state, timed after a warm-up; rank 0 also
    takes the one-process step on the same camera batch (one camera per
    data rank) and saves each step's errors against it."""
    import torch

    from tpusplat_torch import RenderConfig, look_at_camera, random_scene
    from tpusplat_torch.ops import segment_reduce as sr
    from tpusplat_torch.parallel import sharded
    from tpusplat_torch.parallel.mesh import make_render_mesh
    from tpusplat_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n, w, h = scene["n"], scene["width"], scene["height"]
    params = random_scene(n, seed=0, sh_degree=3, scale_range=(0.004, 0.04), extent=4.0,
                          device=dev)
    cfg = RenderConfig(sh_degree=3, strip_gauss_mult=1.5)
    compact = dataclasses.replace(cfg, grad_exchange="compact")
    opt = tstep.make_optimizer(scene_extent=4.0)
    full = tstep.create_train_state(params)
    res = dict(backend=torch.distributed.get_backend(), device=str(dev))
    for dims in meshes:
        mesh = make_render_mesh(*dims)
        batch = dims[0]
        cams = orbit_cameras(look_at_camera, [0.0, 0.5, 9.0], [0.0, 0.0, 0.0], w, h, 60.0,
                             batch, dev)
        targets = torch.rand((batch, h, w, 3), generator=torch.Generator().manual_seed(7)).to(dev)
        state = sharded.shard_state(full, mesh)
        steps = dict(
            dense=(sharded.sharded_train_step, cfg, {}),
            compact=(sharded.sharded_train_step, compact, {}),
            overlap=(sharded.sharded_train_step_overlap, compact, dict(grad_reduce="ring")),
            overlap_psum=(sharded.sharded_train_step_overlap, compact, dict(grad_reduce="psum")))
        whole, out = {}, {}
        for name in SHARDED_STEPS:
            fn, c, kw = steps[name]
            fn(state, cams, targets, c, opt, mesh, **kw)  # warm-up
            sync()
            sr.LAUNCHES = sr.TARGETS_LAUNCHES = sr.MULTIRANGE_LAUNCHES = 0
            t0 = time.perf_counter()
            new, metrics = fn(state, cams, targets, c, opt, mesh, **kw)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            whole[name] = sharded.gather_state(new, mesh)
            out[name] = dict(ms=ms, step=int(new.step),
                             launches=[sr.LAUNCHES, sr.TARGETS_LAUNCHES, sr.MULTIRANGE_LAUNCHES],
                             metrics={k: float(v) for k, v in metrics.items()})
        if rank == 0:
            ref, m = one_process_step(full, cams, targets, cfg, opt)
            for name in SHARDED_STEPS:
                out[name]["errors"] = state_errors(whole[name], ref)
            out["compact_vs_dense"] = state_errors(whole["compact"], whole["dense"])
            out["single"] = dict(loss=float(m["loss"]), step=int(ref.step))
        res["x".join(map(str, dims))] = out
        del whole
    if rank == 0:
        torch.save(res, f"{out_dir}/multi_process.pt")


# Bounds of the sharded steps against the one-process step, the JAX
# package's: the monolithic step's parameters (tests/test_sharded.py:
# 130-135), the overlap step's (tests/test_collectives.py:92-97,
# tests/test_compact_grad.py:133-135), compact against dense
# (tests/test_compact_grad.py:162-164); and of Adam's moments, normalised
# by their largest magnitude.
SHARDED_LOSS_RTOL, SHARDED_PARAM_ATOL, OVERLAP_PARAM_ATOL = 1e-5, 2e-6, 3e-6
COMPACT_PARAM_ATOL, SHARDED_MOMENT_TOL, COMPACT_MOMENT_TOL = 3e-6, 1e-4, 1e-5


def phase_multi_process(torch, phase, meshes, device, backend, scene=PARITY):
    """Ranks of the meshes ``meshes`` in one process each (as many as the
    largest mesh has), started together: each mesh's dense, compact and
    overlap steps against the one-process step. ``device`` "cuda:0" puts
    every rank on the one card (gloo, staging through host memory); "cuda"
    gives rank r the card cuda:r (NCCL)."""
    import pathlib
    import shutil

    from tpusplat_torch import RenderConfig
    from tpusplat_torch.parallel.launch import spawn
    from tpusplat_torch.parallel.sharded import rows_per_shard

    out_dir = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke" / phase
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cfg = RenderConfig(sh_degree=3, strip_gauss_mult=1.5)
    tiles_y = cfg.tile_grid(scene["width"], scene["height"])[1]
    gcaps = {}
    for d, t in meshes:
        nrows = rows_per_shard(scene["height"], cfg, t)
        gcaps[f"{d}x{t}"] = gcap = cfg.strip_gauss_capacity(scene["n"], nrows, tiles_y)
        if gcap is None or gcap >= scene["n"]:
            fail(f"{phase} {d}x{t}: strip compaction is not active (cap {gcap})")
    world = max(d * t for d, t in meshes)
    t0 = time.perf_counter()
    spawn(_multi_process_worker, world, (str(out_dir), meshes, scene),
          init_file=str(out_dir / "init"), device=device, backend=backend, threads=4)
    seconds = time.perf_counter() - t0
    res = torch.load(out_dir / "multi_process.pt", weights_only=False)
    log(phase=phase, n=scene["n"], width=scene["width"], height=scene["height"],
        backend=res["backend"], device=device,
        staging="host memory (gloo)" if res["backend"] == "gloo" else "none",
        gauss_capacity=gcaps, compaction_active=True, seconds=seconds,
        meshes={k: dict(loss_single=v["single"]["loss"],
                        steps={s: dict(ms=v[s]["ms"], loss=v[s]["metrics"]["loss"],
                                       gauss_overflow=v[s]["metrics"]["gauss_overflow"],
                                       a2a_overflow=v[s]["metrics"]["a2a_overflow"],
                                       launches_dense_targets_multirange=v[s]["launches"],
                                       errors=v[s]["errors"])
                               for s in SHARDED_STEPS},
                        compact_vs_dense=v["compact_vs_dense"])
                for k, v in res.items() if isinstance(v, dict)})
    for key, out in ((k, v) for k, v in res.items() if isinstance(v, dict)):
        single = out["single"]
        for name in SHARDED_STEPS:
            r = out[name]
            ovf = {k: v for k, v in r["metrics"].items() if k != "loss" and v}
            if ovf or r["step"] != 1:
                fail(f"{phase} {key} {name}: overflow {ovf}, step {r['step']}")
            if not math.isclose(r["metrics"]["loss"], single["loss"], rel_tol=SHARDED_LOSS_RTOL):
                fail(f"{phase} {key} {name}: loss {r['metrics']['loss']} against "
                     f"{single['loss']}")
            # The JAX bound names three fields: a near-zero gradient of the
            # others may flip its sign, and the first update with it.
            check_state_errors(f"{phase} {key} {name} against the one-process step",
                               r["errors"], OVERLAP_PARAM_ATOL if name.startswith("overlap")
                               else SHARDED_PARAM_ATOL, SHARDED_MOMENT_TOL,
                               fields=("means", "sh", "opacities"))
            if device != "cpu" and name != "dense" and not (r["launches"][1]
                                                            and r["launches"][2]):
                fail(f"{phase} {key} {name}: the compact exchange did not launch both "
                     f"reduce modes ({r['launches']})")
        check_state_errors(f"{phase} {key} compact vs dense", out["compact_vs_dense"],
                           COMPACT_PARAM_ATOL, COMPACT_MOMENT_TOL)
    return res


def phase_trainer_rehearsal(torch, dev):
    """The trainer CLI for 30 steps at 128x128 on the card; the loss falls."""
    import pathlib

    from tpusplat_torch import trainer

    out_dir = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    summary = trainer.main([*REHEARSAL, "--device", dev.type,
                            "--out", str(out_dir / "rehearsal.ply")])
    losses = [v for _, v in summary["losses"]]
    if len(losses) < 2 or not losses[-1] < losses[0]:
        fail(f"trainer rehearsal: the loss did not fall: {losses}")
    log(phase="trainer_rehearsal", seconds=time.perf_counter() - t0, losses=losses,
        final_eval=summary["evals"][-1], step=summary["step"])


def phase_threefry(torch, dev, n=GARDEN["n"]):
    """The densify draws (``prng``, jax.random's threefry stream and normal)
    on the card against the CPU, bit for bit: the normal of every one of the
    2**23 uniforms it can draw, and the pair of [n, 3] draws of the trainer's
    first densify round at the garden capacity (keys ``split(key(0))[1]``
    and its ``fold_in(., 1)``); the pair's milliseconds on the card."""
    from tpusplat_torch.train import prng

    t0 = time.perf_counter()
    every = torch.arange(1 << 23, dtype=torch.int64) << 9
    check_equal("threefry: the normal of every uniform", prng.normal_from_bits(every.to(dev)),
                prng.normal_from_bits(every))
    sub = prng.split(prng.key(0))[1]
    keys = (sub, prng.fold_in(sub, 1))
    for i, k in enumerate(keys):
        check_equal(f"threefry: garden bits {i}", prng.random_bits(k, (n, 3), dev),
                    prng.random_bits(k, (n, 3), "cpu"))
        got, want = prng.normal(k, (n, 3), dev), prng.normal(k, (n, 3), "cpu")
        check_equal(f"threefry: garden draw {i}", got, want)
        if not bool(want.isfinite().all()) or not 0.9 < float(want.std()) < 1.1:
            fail(f"threefry: draw {i} is not a standard normal (std {float(want.std())})")
    pair_ms = cuda_ms(torch, lambda: [prng.normal(k, (n, 3), dev) for k in keys], reps=5) \
        if dev.type == "cuda" else None
    log(phase="threefry", seconds=time.perf_counter() - t0, uniforms=1 << 23,
        garden_shape=[n, 3], bit_equal=True, pair_ms=pair_ms)


# The data_training phase: a COLMAP capture of the garden scene written to
# disk (16 orbit views at 1080p, 100k SfM points from its means), then
# ``trainer --data`` on it at the garden capacity with every eighth view
# held out.
CAPTURE = dict(views=16, points=100_000)
DATA_TRAINING = ["--holdout", "8", "--steps", "60", "--sh-degree", "3", "--capacity",
                 "1400000", "--densify-every", "20", "--eval-every", "30", "--log-every", "10",
                 "--watchdog-secs", "300"]


def _rotmat_to_quat(r):
    """(w, x, y, z) of a rotation matrix (Shepperd's branches)."""
    import numpy as np

    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                         (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def write_colmap_capture(root, cams, images, xyz, rgb):
    """A COLMAP capture in the Mip-NeRF 360 layout (the binary layout of
    tests/test_colmap.py's writers): ``images/`` with one PNG per view,
    ``sparse/0`` with one PINHOLE camera, each view's pose in COLMAP's
    OpenCV frame (the shader frame of ``Camera.view``), and the points."""
    import struct

    import numpy as np

    from tpusplat_torch.io.dataset import save_png

    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    w, h = cams[0].width, cams[0].height
    fx, fy = w / (2 * float(cams[0].tan_fovx)), h / (2 * float(cams[0].tan_fovy))
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, w, h))
        f.write(struct.pack("<4d", fx, fy, w / 2, h / 2))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, (cam, img) in enumerate(zip(cams, images)):
            name = f"view_{i:03d}.png"
            save_png(root / "images" / name, img)
            w2c = cam.view.double().cpu().numpy()  # +y down, +z forward
            f.write(struct.pack("<i", i + 1)
                    + struct.pack("<4d", *_rotmat_to_quat(w2c[:3, :3])))
            f.write(struct.pack("<3d", *w2c[:3, 3]) + struct.pack("<i", 1))
            f.write(name.encode() + b"\x00" + struct.pack("<Q", 0))
    rec = np.zeros(len(xyz), np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                                       ("err", "<f8"), ("track", "<u8")]))
    rec["id"], rec["xyz"], rec["rgb"], rec["err"] = np.arange(len(xyz)), xyz, rgb, 0.5
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(xyz)) + rec.tobytes())


def jax_leaf_specs(n, sh_coeffs):
    """(shape, dtype) of each leaf of the JAX package's ``TrainState`` at
    ``n`` slots, in ``jax.tree_util.tree_flatten`` order: the six parameter
    fields, then per optimizer group in sorted order Adam's count, mu and
    nu (the means' followed by their schedule's count), then step and the
    three densify statistics."""
    rows = dict(means=(n, 3), log_scales=(n, 3), quats=(n, 4), opacities=(n,),
                sh=(n, sh_coeffs, 3))
    specs = [(rows[f], "float32") for f in ("means", "log_scales", "quats", "opacities", "sh")]
    specs.append(((n,), "bool"))
    for group in sorted(rows):
        specs += [((), "int32"), (rows[group], "float32"), (rows[group], "float32")]
        if group == "means":
            specs.append(((), "int32"))
    return specs + [((), "int32")] + [((n,), "float32")] * 3


# The densify round at the garden capacity: alive slots drawn from a seed,
# average gradients uniform in [0, 2 x grad_threshold) (so half the alive
# slots are candidates, more than the free slots), a share of the alive
# slots nearly transparent (opacity in [0.001, 0.004], under min_opacity
# 0.005), and scene_extent 1.0, so that the clone/split limit of 0.01
# falls inside the garden scales (0.002-0.02).
DENSIFY_ROUND = dict(alive=1_000_000, seed=11, faint=0.02, scene_extent=1.0)


def densify_round(torch, dev, params, spec=DENSIFY_ROUND):
    """One ``densify_and_prune`` on the card at the garden capacity that
    grants slots, against the same round on a CPU copy of the state, given
    the card's draws: alive and the granted target slots bit-equal (and
    equal to the ranking's contract: the j-th candidate by average gradient
    takes the j-th free slot); the parameters and moments within 2e-6,
    apart from Gaussians whose clone-or-split decision differs, which must
    lie within 4 ulp of the limit. Returns the round's ms on the card (CUDA
    events, draws included and given), the counts of clones, splits and
    prunes, and the decisions that differ."""
    import numpy as np

    from tpusplat_torch.train import prng
    from tpusplat_torch.train import step as tstep
    from tpusplat_torch.train.checkpoint import state_tensors
    from tpusplat_torch.train.densify import DensifyConfig, densify_and_prune

    n, extent, dcfg = params.num_gaussians, spec["scene_extent"], DensifyConfig()
    g = torch.Generator().manual_seed(spec["seed"])
    alive = torch.zeros(n, dtype=torch.bool)
    alive[torch.randperm(n, generator=g)[:spec["alive"]]] = True
    faint = torch.rand(n, generator=g) < spec["faint"]
    op = 0.001 + 0.003 * torch.rand(n, generator=g)
    host = _to(params, "cpu")
    host = dataclasses.replace(host, alive=alive, opacities=torch.where(
        faint, torch.log(op / (1 - op)), host.opacities))
    state = tstep.create_train_state(host)
    state.mu = {k: 1e-3 * torch.randn(v.shape, generator=g) for k, v in state.mu.items()}
    state.nu = {k: 1e-6 * torch.rand(v.shape, generator=g) for k, v in state.nu.items()}
    state.count = {k: torch.tensor(500, dtype=torch.int32) for k in state.count}
    state.step = torch.tensor(500, dtype=torch.int32)
    state.grad_count = torch.randint(1, 20, (n,), generator=g).float()
    state.grad_accum = torch.rand(n, generator=g) * (2 * dcfg.grad_threshold) * state.grad_count
    state.max_radii = 30 * torch.rand(n, generator=g)
    card = _to(state, dev)

    key = prng.fold_in(prng.key(0), 7)
    noise = prng.normal(key, (n, 3), dev)
    noise2 = prng.normal(prng.fold_in(key, 1), (n, 3), dev)
    got = densify_and_prune(card, key, dcfg, extent)
    want = densify_and_prune(state, key, dcfg, extent, noise=noise.cpu(), noise2=noise2.cpu())
    ms = ms_given = None
    if dev.type == "cuda":
        ms = cuda_ms(torch, lambda: densify_and_prune(card, key, dcfg, extent), reps=3)
        ms_given = cuda_ms(torch, lambda: densify_and_prune(
            card, key, dcfg, extent, noise=noise, noise2=noise2), reps=3)

    # The ranking's contract: candidates by average gradient, best first
    # (ties by slot), take the free slots in ascending order.
    avg = state.grad_accum / state.grad_count.clamp_min(1.0)
    cand = alive & (avg >= dcfg.grad_threshold)
    free = torch.nonzero(~alive).flatten()
    best = torch.argsort(torch.where(cand, -avg, math.inf), stable=True)
    granted = best[:min(int(cand.sum()), len(free))]
    target = torch.full((n,), -1, dtype=torch.int64)
    target[granted] = free[:len(granted)]
    if not len(granted) < int(cand.sum()):
        fail(f"densify_round: {int(cand.sum())} candidates do not outnumber {len(free)} free "
             "slots")

    def outcome(out):
        """(alive, the free slots filled, the Gaussians that split)."""
        means, log_scales = out.params.means.cpu(), out.params.log_scales.cpu()
        filled = ~alive & (means != state.params.means).any(-1)
        split = alive & (log_scales != state.params.log_scales).any(-1)
        return out.params.alive.cpu(), filled, split

    alive_g, filled_g, split_g = outcome(got)
    alive_w, filled_w, split_w = outcome(want)
    check_equal("densify_round: alive", alive_g, alive_w)
    check_equal("densify_round: granted target slots", filled_g, filled_w)
    filled = torch.zeros(n, dtype=torch.bool)
    filled[free[:len(granted)]] = True
    check_equal("densify_round: target slots against the ranking", filled_w, filled)
    if bool(((split_g | split_w) & (target < 0)).any()):
        fail("densify_round: a Gaussian without a slot split")

    # Decisions that differ must sit within 4 ulp of the clone/split limit.
    differ = torch.nonzero(split_g != split_w).flatten()
    limit = np.float32(dcfg.percent_dense * extent)
    max_scale = torch.exp(state.params.log_scales[differ]).max(-1).values.numpy()
    if np.any(np.abs(max_scale - limit) > 4 * np.spacing(limit)):
        fail(f"densify_round: {len(differ)} split decisions differ, not all within 4 ulp of "
             f"{limit}: largest scales {max_scale.tolist()[:8]}")
    keep = torch.ones(n, dtype=torch.bool)
    keep[differ] = False
    keep[target[differ]] = False
    errs = {}
    for k, v in state_tensors(want).items():
        a = state_tensors(got)[k].cpu()
        if v.dim() == 0:
            check_equal(f"densify_round: {k}", a, v)
            continue
        errs[k] = check_close(f"densify_round: {k}", a[keep].float(), v[keep].float(),
                              atol=2e-6)
    clones = int((target >= 0).sum()) - int(split_w.sum())
    return dict(slots=n, alive_before=int(alive.sum()), candidates=int(cand.sum()),
                free=len(free), granted=len(granted), clones=clones, splits=int(split_w.sum()),
                prunes=int(((alive | filled) & ~alive_w).sum()), alive_after=int(alive_w.sum()),
                decisions_differ=len(differ), max_abs_err=max(errs.values()), ms=ms,
                ms_noise_given=ms_given)


def _to(x, dev):
    """A tensor, or a dict or dataclass of them (nested), copied to ``dev``."""
    if isinstance(x, dict):
        return {k: v.to(dev) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return x.__class__(**{f.name: _to(getattr(x, f.name), dev)
                              for f in dataclasses.fields(x)})
    return x.to(dev)


def phase_data_training(torch, dev, params, cams, cfg, capture=CAPTURE, argv=DATA_TRAINING):
    """The trainer's real-data path at the garden shapes: a COLMAP capture
    written to disk and read back, ``trainer --data`` with a held-out eval,
    a checkpoint and the watchdog; the checkpoint against the final state;
    the native .ply reader against numpy; the validation counters on a
    clean and a poisoned garden frame; render_batch."""
    import contextlib
    import io
    import pathlib
    import shutil

    import numpy as np

    from tpusplat_torch import trainer
    from tpusplat_torch.camera import look_at_camera
    from tpusplat_torch.config import SH_C0
    from tpusplat_torch.io import colmap, native_loader
    from tpusplat_torch.io.dataset import read_image
    from tpusplat_torch.io.ply import load_ply
    from tpusplat_torch.ops import emission, rasterize, segment_reduce
    from tpusplat_torch.render import render, render_auto, render_batch, render_stages
    from tpusplat_torch.train import prng
    from tpusplat_torch.train import step as tstep
    from tpusplat_torch.train.checkpoint import (JAX_TREEDEF, load_checkpoint, save_checkpoint,
                                                 state_tensors)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    out_dir = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke" / "data"
    shutil.rmtree(out_dir, ignore_errors=True)
    root = out_dir / "capture"
    root.mkdir(parents=True)
    seconds = {}

    # 1. The capture: the garden scene's renders from an orbit, and SfM
    # points drawn from its means, coloured from their SH DC.
    w, h = cams[0].width, cams[0].height
    views = orbit_cameras(look_at_camera, [0.0, 0.5, 9.0], [0.0, 0.0, 0.0], w, h, 60.0,
                          capture["views"], dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        renders, gcfg = [], cfg
        for cam in views:
            img, aux, gcfg = render_auto(params, cam, gcfg)
            if int(aux["capacity_overflow"]):
                fail("data_training: a capture render overflowed")
            renders.append(img.clamp(0.0, 1.0))
    pick = np.random.default_rng(0).choice(params.num_gaussians, capture["points"],
                                           replace=False)
    xyz = params.means[torch.from_numpy(pick).to(dev)].double().cpu().numpy()
    dc = params.sh[torch.from_numpy(pick).to(dev), 0].cpu().numpy()
    rgb = np.round(np.clip(SH_C0 * dc + 0.5, 0.0, 1.0) * 255.0).astype(np.uint8)
    write_colmap_capture(root, views, renders, xyz, rgb)
    seconds["write_capture"] = time.perf_counter() - t0

    # 2. Read it back: cameras, points and the k-NN init, images.
    (got_cams, names, init), seconds["load_colmap_scene"] = timed(
        lambda: colmap.load_colmap_scene(str(root), device=dev))
    xyz_r, rgb_r = colmap.read_points3d_bin(str(root / "sparse" / "0" / "points3D.bin"))
    _, seconds["knn_init"] = timed(lambda: colmap.init_from_points(xyz_r, rgb_r, device=dev))
    if init.num_gaussians != capture["points"] or init.means.device.type != dev.type:
        fail(f"data_training: {init.num_gaussians} seeded Gaussians on {init.means.device}")
    for cam, want in zip(got_cams, views):
        for f in ("view", "proj"):
            err = float((getattr(cam, f) - getattr(want, f)).abs().max())
            if not err <= 1e-5:
                fail(f"data_training: a read-back {f} matrix is off by {err}")
    t0 = time.perf_counter()
    for nm, want in zip(names, renders):
        img = torch.from_numpy(read_image(str(root / "images" / nm))[..., :3]).to(dev)
        check_close(f"data_training: image {nm}", img, want, atol=0.5 / 255 + 1e-6)
    seconds["png_read"] = time.perf_counter() - t0
    del init, renders

    # 3. The trainer on the capture, the launch counters reset just before
    # and read just after, and its densify draws (prng.normal) recorded.
    ply, ckpt = out_dir / "trained.ply", out_dir / "state.npz"
    sync()
    emission.LAUNCHES = rasterize.FORWARD_LAUNCHES = rasterize.BACKWARD_LAUNCHES = 0
    segment_reduce.LAUNCHES = 0
    draws, prng_normal = [], prng.normal

    def recorded_normal(k, shape, device):
        out = prng_normal(k, shape, device)
        draws.append((tuple(out.shape), out.device.type))
        return out

    err = io.StringIO()
    t0 = time.perf_counter()
    prng.normal = recorded_normal
    try:
        with contextlib.redirect_stderr(err):
            summary = trainer.main(["--data", str(root), *argv, "--ckpt", str(ckpt),
                                    "--out", str(ply), "--device", dev.type])
    finally:
        prng.normal = prng_normal
    seconds["trainer"] = time.perf_counter() - t0
    capacity = int(argv[argv.index("--capacity") + 1])
    if not draws or len(draws) % 2 or set(draws) != {((capacity, 3), dev.type)}:
        fail(f"data_training: the densify rounds did not draw their [{capacity}, 3] split "
             f"noise pairs on {dev.type}: {draws}")
    launches = dict(emission=emission.LAUNCHES, forward_blend=rasterize.FORWARD_LAUNCHES,
                    backward_blend=rasterize.BACKWARD_LAUNCHES,
                    segment_reduce=segment_reduce.LAUNCHES)
    sys.stderr.write(err.getvalue())
    lines = [json.loads(ln) for ln in err.getvalue().splitlines() if ln.startswith("{")]
    steps = summary["step"]
    losses = [v for _, v in summary["losses"]]
    evals = summary["evals"]
    seeded = [ln for ln in lines if "colmap_points" in ln]
    if not seeded or seeded[0]["seeded"] != capture["points"]:
        fail(f"data_training: the SfM points did not seed the model ({seeded})")
    if len(losses) < 2 or not losses[-1] < losses[0]:
        fail(f"data_training: the loss did not fall: {losses}")
    if any(ln["overflow"] for ln in lines if "overflow" in ln):
        fail(f"data_training: a logged step or eval overflowed: {lines}")
    if not all(e["holdout"] and e["views"] == capture["views"] // 8 for e in evals):
        fail(f"data_training: the evals are not on the held-out views: {evals}")
    if not evals[-1]["final"] or not evals[-1]["psnr"] > evals[0]["psnr"]:
        fail(f"data_training: held-out PSNR did not rise: {[e['psnr'] for e in evals]}")
    if dev.type == "cuda" and any(v < steps for v in launches.values()):
        fail(f"data_training: a kernel launched fewer times than the {steps} steps: "
             f"{launches}")

    # 4. The checkpoint: the JAX package's layout at this capacity; against
    # the trainer's final state, and one step from each, bit for bit.
    state = summary["state"]
    specs = jax_leaf_specs(capacity, state.params.sh.shape[1])
    with np.load(ckpt) as data:
        want_files = {"__treedef__", *(f"leaf_{i}" for i in range(len(specs)))}
        if set(data.files) != want_files:
            fail(f"data_training: the checkpoint's files {sorted(data.files)} are not the "
                 f"JAX layout's {sorted(want_files)}")
        if data["__treedef__"].dtype != np.uint8 or \
                data["__treedef__"].tobytes() != JAX_TREEDEF.encode():
            fail("data_training: the checkpoint's __treedef__ is not the JAX train state's")
        for i, (shape, dtype) in enumerate(specs):
            a = data[f"leaf_{i}"]
            if a.shape != shape or str(a.dtype) != dtype:
                fail(f"data_training: checkpoint leaf_{i} is {a.dtype} {a.shape}, JAX's "
                     f"{dtype} {shape}")
    restored, seconds["checkpoint_load"] = timed(lambda: load_checkpoint(ckpt, state))
    for k, v in state_tensors(state).items():
        r = state_tensors(restored)[k]
        if r.device != v.device or not torch.equal(r, v):
            fail(f"data_training: checkpoint {k} differs from the final state")
    _, seconds["checkpoint_save"] = timed(lambda: save_checkpoint(ckpt, restored))
    cam0 = got_cams[1]  # a training view (views 0 and 8 are held out)
    target = torch.from_numpy(read_image(str(root / "images" / names[1]))[..., :3]).to(dev)
    step_cfg = summary["cfg"]  # the capacity the trainer's regrows reached
    opt = tstep.make_optimizer(scene_extent=4.0)
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # no run-to-run choice of algorithm
    try:
        (a, ma), (b, mb) = (tstep.train_step(s, cam0, target, step_cfg, opt)
                            for s in (state, restored))
    finally:
        torch.backends.cudnn.deterministic = cudnn
    if int(ma["capacity_overflow"]) or int(a.step) != steps + 1:
        fail("data_training: the step after the checkpoint overflowed")
    for k, v in state_tensors(a).items():
        if not torch.equal(state_tensors(b)[k], v):
            fail(f"data_training: a step from the checkpoint differs in {k}")
    del state, restored, a, b, summary

    # 5. The native .ply reader against numpy, field by field.
    _, seconds["native_build"] = timed(native_loader.build)
    native, seconds["ply_read_native"] = timed(lambda: load_ply(ply, device=dev))
    plain, seconds["ply_read_numpy"] = timed(lambda: load_ply(ply, device=dev,
                                                              use_native=False))
    for f in dataclasses.fields(native):
        if not torch.equal(getattr(native, f.name), getattr(plain, f.name)):
            fail(f"data_training: native .ply read differs from numpy in {f.name}")
    n_ply = native.num_gaussians
    del native, plain

    # 6. Validation on a garden frame: counters 0 and the frame unchanged;
    # a NaN mean raises; the clean frame afterwards is the same.
    t0 = time.perf_counter()
    with torch.no_grad():
        dbg = dataclasses.replace(cfg, debug_checks=True)
        img, aux = render_stages(params, cams[0], cfg)
        img_d, aux_d = render_stages(params, cams[0], dbg)
        counters = {k: int(v) for k, v in aux_d["debug"].items()}
        if any(counters.values()) or int(aux["capacity_overflow"]):
            fail(f"data_training: validation counters on a clean frame: {counters}")
        if not (torch.equal(img, img_d) and torch.equal(aux["transmittance"],
                                                        aux_d["transmittance"])):
            fail("data_training: the frame with debug_checks differs")
        means = params.means.clone()
        means[7] = float("nan")
        try:
            render(dataclasses.replace(params, means=means), cams[0], dbg)
        except RuntimeError as e:
            if "validation failed" not in str(e):
                fail(f"data_training: a NaN mean raised another error: {e}")
            raised = str(e)
        else:
            fail("data_training: a NaN mean did not trip the validation")
        del means
        sync()
        if not torch.equal(render_stages(params, cams[0], cfg)[0], img):
            fail("data_training: the clean frame after the poisoned one differs")

        # 7. render_batch against one render_stages per camera.
        batch = render_batch(params, cams, cfg)
        for i, cam in enumerate(cams):
            if not torch.equal(batch[i], render_stages(params, cam, cfg)[0]):
                fail(f"data_training: render_batch camera {i} differs")
    seconds["validation_and_batch"] = time.perf_counter() - t0
    shutil.rmtree(out_dir, ignore_errors=True)

    # 8. A densify round that grants slots at the garden capacity.
    t0 = time.perf_counter()
    round_ = densify_round(torch, dev, params)
    seconds["densify_round"] = time.perf_counter() - t0
    log(phase="data_training", width=w, height=h, views=capture["views"],
        held_out=evals[0]["views"], points=capture["points"], steps=steps, losses=losses,
        evals=[{k: e[k] for k in ("eval_step", "psnr", "ssim", "views", "overflow")}
               for e in evals], ply_gaussians=n_ply, launches=launches,
        densify_draws=len(draws), alive=[ln["alive"] for ln in lines if "alive" in ln],
        nan_mean=raised, checkpoint_leaves=len(specs), densify_round=round_, seconds=seconds)
    return launches


# The session phase: scripted keys through the interactive loop at the
# garden shapes, profiled every second frame, then a resize.
SESSION_KEYS = ["w", "w", "d", "left", "up", None, "q"]
SESSION_EYE, SESSION_RESIZE = (0.0, 0.5, 9.0), (1280, 720)
# The dryrun's ranks, all on the one card over gloo (mesh 2x2); the strips of
# the strip bench.
DRYRUN_RANKS, BENCH_STRIPS = 4, 8


def phase_session(torch, dev, params, cfg):
    """The interactive session at the garden shapes: ``run_interactive``
    on scripted keys, the launch counters reset just before and read just
    after; the pose against the motion constants, frame 0 and a frame after
    a resize bit-equal to ``render_auto`` at the same camera."""
    import io

    import numpy as np

    from tpusplat_torch.camera import make_camera
    from tpusplat_torch.interactive import run_interactive
    from tpusplat_torch.ops import emission, rasterize
    from tpusplat_torch.render import render_auto
    from tpusplat_torch.session import MOVE_STEP, Session, SessionConfig

    w, h = GARDEN["width"], GARDEN["height"]
    sess = Session(SessionConfig(width=w, height=h, fov=60.0, render=cfg), params=params,
                   device=dev)
    # The identity rotation looks down -z: from (0, 0.5, 9), at the scene.
    sess.position = np.array(SESSION_EYE)
    frames, stages = [], []
    draw, draw_profiled = sess.draw, sess.draw_profiled

    def recorded(fn, sink):
        def call():
            pose = (sess.position.copy(), sess.rotation.copy(), sess.config.render)
            out = fn()
            sink.append((pose, out))
            return out
        return call

    sess.draw = recorded(draw, frames)
    sess.draw_profiled = recorded(draw_profiled, stages)
    text = io.StringIO()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    emission.LAUNCHES = rasterize.FORWARD_LAUNCHES = 0
    stats = run_interactive(sess, keys=SESSION_KEYS, out=text, cols=96, profile_every=2)
    launches = dict(emission=emission.LAUNCHES, forward_blend=rasterize.FORWARD_LAUNCHES)
    seconds = time.perf_counter() - t0
    out = text.getvalue()
    n_frames = len([k for k in SESSION_KEYS if k not in (None, "q")])
    if stats["frames"] != n_frames or len(frames) + len(stages) != n_frames:
        fail(f"session: {stats['frames']} frames, expected {n_frames}")
    if min(launches.values()) < n_frames:
        fail(f"session: a kernel was not launched every frame ({launches})")
    # Three moves (w, w, d) from the identity rotation, then two rotations.
    want = np.array(SESSION_EYE) + MOVE_STEP * np.array([1.0, 0.0, -2.0])
    if np.abs(np.asarray(stats["position"]) - want).max() > 1e-9:
        fail(f"session: position {stats['position']}, expected {want.tolist()}")
    if "(live)" not in out or f"frame {n_frames} " not in out or "instances" not in out:
        fail("session: the overlay lacks the status line or the live stage line")

    def reference(pose, size):
        pos, rot, rcfg = pose
        cam = make_camera(pos, rot, *size, fov_deg=60.0, device=dev)
        with torch.no_grad():
            return render_auto(params, cam, rcfg)[0]

    (pose0, (img0, aux0)) = frames[0]
    check_equal("session frame 0 against render_auto", img0, reference(pose0, (w, h)))
    if float(img0.max()) <= 0.0 or int(aux0["capacity_overflow"]):
        fail("session: frame 0 is black or truncated")
    sess.resize(*SESSION_RESIZE)
    img_r, _ = sess.draw()
    pose_r = frames[-1][0]
    if img_r.shape != (SESSION_RESIZE[1], SESSION_RESIZE[0], 3):
        fail(f"session: the resized frame is {tuple(img_r.shape)}")
    check_equal("session frame after resize against render_auto", img_r,
                reference(pose_r, SESSION_RESIZE))
    frame_ms = [float(line.split()[2]) for line in out.splitlines()
                if line.startswith("frame ")]
    log(phase="session", width=w, height=h, keys=SESSION_KEYS, frames=stats["frames"],
        seconds=seconds, frame_ms=frame_ms, ema_ms=stats["ema_ms"],
        stage_ms=[st[2] for _, st in stages], position=stats["position"],
        num_instances=[int(a["num_instances"]) for _, (_, a) in frames],
        capacity=sess.config.render.instance_capacity(params.num_gaussians),
        launches=launches, frame0="bit-equal to render_auto",
        resized=dict(size=SESSION_RESIZE, frame="bit-equal to render_auto"))
    return launches


def phase_dryrun(torch, dev):
    """``run_dryrun`` as four ranks on the one card over gloo (mesh 2x2):
    every assertion of the JAX dryrun, and each rank launches every kernel."""
    from tpusplat_torch.parallel.dryrun import mesh_dims, run_dryrun

    t0 = time.perf_counter()
    run_dryrun(DRYRUN_RANKS, device="cuda:0" if dev.type == "cuda" else "cpu",
               backend="gloo")
    log(phase="dryrun", ranks=DRYRUN_RANKS, mesh="x".join(map(str, mesh_dims(DRYRUN_RANKS))),
        backend="gloo", seconds=time.perf_counter() - t0,
        result="sharded render == one-process render; overlap == monolithic loss; "
               "compact == dense exchange; every kernel launched on every rank")


def phase_profile_detail(torch, dev):
    """The per-stage profiler at the garden config, with its profiler
    window's device idle share."""
    from tpusplat_torch.bench import profile_detail

    t0 = time.perf_counter()
    res = profile_detail.run("garden", dev)
    win = res["train_window"]
    log(phase="profile_detail", seconds=time.perf_counter() - t0, **res)
    if win["overflow"]:
        fail(f"profile_detail: the profiled train steps overflowed ({win['overflow']})")
    if not win["profiler_device_events"]:
        print("chip_smoke: profile_detail: the profiler window recorded no device activity",
              file=sys.stderr)
    return res


def phase_gpu_gate(torch, dev):
    """The GPU gate's five checks; the run fails unless every one passed."""
    from tpusplat_torch.bench import gpu_gate

    t0 = time.perf_counter()
    out = gpu_gate.run(dev)
    log(phase="gpu_gate", seconds=time.perf_counter() - t0, **out)
    failed = [k for k, v in out.items() if isinstance(v, dict) and v.get("pass") is False]
    if not out["pass"]:
        fail(f"gpu_gate: {failed} failed")
    return out


def phase_bench_tools(torch, dev):
    """Each bench module once at the garden shapes (kernel_bench twice: its
    inputs built, then read from its cache), its JSON logged."""
    from tpusplat_torch.bench import kernel_bench, micro, plumb_bench, profile_detail, scaling
    from tpusplat_torch.bench import strip_bench
    from tpusplat_torch.bench.strip_projection import measure_strip_projection

    out = {}
    for name, fn in (
            ("kernel_bench", lambda: kernel_bench.run("garden", dev)),
            # again, from the inputs the first run cached
            ("kernel_bench_cached", lambda: kernel_bench.run("garden", dev)),
            ("plumb_bench", lambda: plumb_bench.run(device=dev)),
            ("micro", lambda: micro.run(dev)),
            ("strip_bench", lambda: strip_bench.run(BENCH_STRIPS, dev)),
            ("strip_projection", lambda: measure_strip_projection(
                *profile_detail.scene("garden", dev), BENCH_STRIPS,
                t_full_ms=out["strip_bench"]["t_full_frame_1card_ms"])),
            ("scaling", lambda: scaling.run(2, "cuda:0" if dev.type == "cuda" else "cpu",
                                            "gloo"))):
        t0 = time.perf_counter()
        out[name] = fn()
        log(phase=f"bench_tools.{name}", seconds=time.perf_counter() - t0, **out[name])
        torch.cuda.empty_cache()
    return out


# The headline harness (bench.py's counterpart): its configurations in the
# order they run, its iterations, and the capacities the JAX package settled
# at garden and bicycle scale on its TPU (a record, not a gate).
HEADLINE_CONFIGS, HEADLINE_ITERS = ("small", "mid", "garden", "bicycle"), 5
HEADLINE_LINES = dict(garden=("fwd+bwd", "viewer", "VIEWER", "strip", "STRIP", "fwd+bwd"),
                      other=("fwd+bwd", "fwd+bwd"))
JAX_CAPACITY = dict(garden=(4_397_056, "BENCH_r05.json"),
                    bicycle=(12_484_608, "docs/PROFILE.md:176"))


def phase_headline(torch, dev):
    """``bench.headline`` in process at each of ``HEADLINE_CONFIGS`` (garden
    with every line, the others with the fwd+bwd line), the launch counters
    reset just before each run and read just after; then one headline step
    with the counters reset (its launches, and its loss: a black image has
    loss 0). Fails on overflow, a value not finite and positive, a black
    image, or a kernel of the step not launched in a run. At garden, a
    profiler window over three headline steps (the device's idle share and
    its top kernels); at bicycle, every kernel of the step held against its
    plain version on bicycle's inputs (``phase_kernels``)."""
    from tpusplat_torch.bench import headline, profile_detail
    from tpusplat_torch.ops import emission, rasterize, segment_reduce

    def counters():
        return dict(emission=emission.LAUNCHES, forward_blend=rasterize.FORWARD_LAUNCHES,
                    backward_blend=rasterize.BACKWARD_LAUNCHES,
                    segment_reduce=segment_reduce.LAUNCHES)

    def reset():
        emission.LAUNCHES = rasterize.FORWARD_LAUNCHES = 0
        rasterize.BACKWARD_LAUNCHES = segment_reduce.LAUNCHES = 0

    out = {}
    for conf in HEADLINE_CONFIGS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params, cam, cfg = inputs = headline.scene(conf, dev)
        n = params.num_gaussians
        capacity = cfg.instance_capacity(n)
        setup_s = time.perf_counter() - t0
        reset()
        lines = headline.run(conf, dev, iters=HEADLINE_ITERS, inputs=inputs)
        launches = counters()
        peak = torch.cuda.max_memory_allocated()
        reset()
        loss, grads, aux = headline.loss_and_grads(*headline.split_trainable(params), cam, cfg)
        torch.cuda.synchronize()
        step_launches = counters()
        # a detail line's mode, or a metric line's first word
        kinds = [ln["mode"] if "mode" in ln else ln["metric"].split(" ")[0] for ln in lines]
        want = HEADLINE_LINES["garden" if conf == "garden" else "other"]
        if kinds != list(want) or "metric" not in lines[-1]:
            fail(f"headline {conf}: lines {kinds}, expected {want}, the headline last")
        values = [ln[k] for ln in lines for k in ("host_ms", "event_ms", "value", "mpix_per_s",
                                                  "strip_ms_max") if k in ln]
        if not all(math.isfinite(v) and v > 0 for v in values):
            fail(f"headline {conf}: a time or rate not finite and positive: {values}")
        if int(aux["capacity_overflow"]) != 0:
            fail(f"headline {conf}: capacity overflow {int(aux['capacity_overflow'])}")
        if not (math.isfinite(float(loss)) and float(loss) > 0.0):
            fail(f"headline {conf}: loss {float(loss)}: the image is black or not finite")
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            fail(f"headline {conf}: a gradient not finite")
        if min(launches.values()) < 1 or min(step_launches.values()) < 1:
            fail(f"headline {conf}: a kernel not launched ({launches}; a step "
                 f"{step_launches})")
        res = dict(config=conf, n=n, width=cam.width, height=cam.height, capacity=capacity,
                   num_instances=int(aux["num_instances"]), setup_s=setup_s,
                   seconds=time.perf_counter() - t0, peak_mem_bytes=peak,
                   peak_mem_gib=peak / 2**30, loss=float(loss), launches=launches,
                   launches_step=step_launches,
                   mpix={ln["metric"]: ln["value"] for ln in lines if "metric" in ln})
        if conf in JAX_CAPACITY:
            jax_cap, source = JAX_CAPACITY[conf]
            res["jax_capacity"] = dict(capacity=jax_cap, source=source,
                                       gap=(capacity - jax_cap) / jax_cap)
        log(phase="headline", **res)
        out[conf] = res
        del grads, aux
        if conf == "garden":
            t0 = time.perf_counter()
            trainable, alive = headline.split_trainable(params)
            win = profile_detail.profile_window(
                lambda: headline.step(trainable, alive, cam, cfg), dev, steps=3)
            res["profile_window"] = win
            log(phase="headline_profile", config=conf, seconds=time.perf_counter() - t0,
                host_ms=lines[0]["host_ms"], event_ms=lines[0]["event_ms"], **win)
            if not win["profiler_device_events"]:
                print("chip_smoke: headline_profile: the profiler window recorded no device "
                      "activity", file=sys.stderr)
            del trainable, alive
        if conf == "bicycle":
            torch.cuda.empty_cache()
            res["kernels"] = phase_kernels(torch, dev, params, cam, cfg, label="bicycle")
        del params, inputs
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nccl", action="store_true",
                   help=f"only the sharded steps over NCCL, a card per rank, on meshes "
                        f"{NCCL_MESHES} (needs {NCCL_CARDS} cards)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the GPU",
              file=sys.stderr)
        return 1
    kind, smi = torch.cuda.get_device_name(0), nvidia_smi()
    if args.nccl:
        return run_nccl(torch, kind, smi)
    return run(torch, torch.device("cuda"), kind, smi)


def run_nccl(torch, kind: str, smi: str) -> int:
    """``--nccl``: the sharded steps with a card per rank over NCCL, the
    path of ``trainer --mesh`` under torchrun, against the one-process
    step; no other phase."""
    if torch.cuda.device_count() < NCCL_CARDS:
        print(f"chip_smoke --nccl: needs {NCCL_CARDS} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    start(torch, kind, smi)
    phase_multi_process(torch, "sharded_nccl", NCCL_MESHES, "cuda", "nccl")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def garden_inputs(torch, dev):
    """bench.py's garden configuration: (params, the 3-camera orbit, cfg
    with the capacity from a preprocess probe x1.05)."""
    from tpusplat_torch import RenderConfig, look_at_camera, random_scene
    from tpusplat_torch.ops.preprocess import preprocess

    n, w, h = GARDEN["n"], GARDEN["width"], GARDEN["height"]
    params = random_scene(n, seed=0, sh_degree=3, scale_range=(0.002, 0.02), extent=4.0,
                          device=dev)
    cams = orbit_cameras(look_at_camera, [0.0, 0.5, 9.0], [0.0, 0.0, 0.0], w, h, 60.0, 3,
                         dev)
    cfg = RenderConfig(sh_degree=3, capacity_mult=4, max_per_tile=4096, tight_radius=True)
    with torch.no_grad():
        needed = int(preprocess(params, cams[0], cfg).ntiles.sum())
    return params, cams, dataclasses.replace(cfg, capacity=int(needed * 1.05))


def start(torch, kind: str, smi: str):
    """The device line, and every kernel built (in parallel) before any
    phase, so that ranks started later never build into ``build/`` at
    once; a register spill fails the run."""
    from tpusplat_torch.ops import _build

    # Parity precision: the plain blend's colour sum is a matmul, and the
    # SSIM filter a cuDNN convolution.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    report = _build.build(verbose=True)
    ptxas = {k: [ln.strip() for ln in v["log"].splitlines()
                 if "registers" in ln or "spill" in ln] for k, v in report.items()}
    log(phase="build", seconds=time.perf_counter() - t0,
        kernels={k: dict(seconds=v["seconds"], ptxas=ptxas[k]) for k, v in report.items()})
    spills = [ln for lines in ptxas.values() for ln in lines
              if re.search(r"[1-9]\d* bytes spill", ln)]
    if spills:
        fail(f"register spills: {spills}")


def run(torch, dev, kind: str, smi: str) -> int:
    start(torch, kind, smi)
    with torch.no_grad():
        phase_parity(torch, dev)
    phase_grad_6k(torch, dev)

    params, cams, cfg = garden_inputs(torch, dev)
    with torch.no_grad():
        cfg, serving = phase_garden_serving(torch, dev, params, cams, cfg)
    cfg, training = phase_garden_training(torch, dev, params, cams, cfg)
    timed = phase_kernels(torch, dev, params, cams[0], cfg)
    phase_trainer_rehearsal(torch, dev)
    phase_threefry(torch, dev)
    data = phase_data_training(torch, dev, params, cams, cfg)
    timed.update(phase_sharded_emulated(torch, dev, params, cams[0], cfg))
    session = phase_session(torch, dev, params, cfg)
    del params
    torch.cuda.empty_cache()
    phase_multi_process(torch, "sharded_two_process", [TWO_PROCESS_MESH],
                        "cuda:0" if dev.type == "cuda" else "cpu", "gloo")
    phase_dryrun(torch, dev)
    phase_profile_detail(torch, dev)
    torch.cuda.empty_cache()
    phase_gpu_gate(torch, dev)
    torch.cuda.empty_cache()
    phase_bench_tools(torch, dev)
    headline = phase_headline(torch, dev)

    sources = dict(
        emission=("tpusplat_torch/csrc/emission.cu", "tpusplat/ops/emission.py:76"),
        forward_blend=("tpusplat_torch/csrc/rasterize_forward.cu",
                       "tpusplat/ops/rasterize_pallas.py:220"),
        backward_blend=("tpusplat_torch/csrc/rasterize_backward.cu",
                        "tpusplat/ops/rasterize_pallas.py:326"),
        segment_reduce=("tpusplat_torch/csrc/segment_reduce.cu",
                        "tpusplat/ops/rasterize_pallas.py:738 (dense mode)"),
        segment_reduce_targets=("tpusplat_torch/csrc/segment_reduce.cu",
                                "tpusplat/ops/rasterize_pallas.py:738 (streamed-target mode)"),
        segment_reduce_multirange=("tpusplat_torch/csrc/segment_reduce.cu",
                                   "tpusplat/ops/rasterize_pallas.py:738 (multi-range mode)"),
    )
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timed[name]
        # The serving and training kernels count over the garden training
        # steps (and over the data_training trainer run); the two sharded
        # modes over the emulated strip's path.
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=training[name] if name in training else t["launches"],
            launches_serving=serving.get(name), launches_data_training=data.get(name),
            launches_session=session.get(name),
            launches_headline=headline["garden"]["launches"].get(name),
            launches_headline_step=headline["garden"]["launches_step"].get(name),
            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
            **{k: t[k] for k in ("kernel_ms", "ms_is", "wrapper_ms", "runs_route_ms",
                                 "library_is", "library_live_ms", "bound_unculled_ms")
               if k in t}))
    if any(training[k] < len(cams) for k in training) or \
            any(k["launches"] < 1 for k in kernels):
        fail(f"launch counts {training} below one a step, or a sharded mode unlaunched")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
