"""Smoke run of the PyTorch/CUDA port (tpusplat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each; any failure exits non-zero:
  1. device: a CUDA device is required (exit 1 without one); prints its
     name and ``nvidia-smi``'s name and power limit;
  2. build: compiles every kernel of the serving path from ``csrc/`` with
     nvcc (in parallel) and prints the ptxas resource report;
  3. parity at 100k Gaussians, 800x800, SH3 (BASELINE config 2): the
     emission kernel against its plain version (bit-equal), the CUDA
     bin_and_sort against the CPU one on the same preprocessed Gaussians
     (bit-equal), the forward-blend kernel against its plain version
     (image atol 3e-5 rtol 1e-4, transmittance atol 3e-5);
  4. garden serving: 1.4M Gaussians at 1920x1080, SH3, tight radius,
     capacity from a preprocess probe x1.05; ``render_auto`` on a 3-camera
     orbit with the launch counters reset just before and read just after;
     then each kernel against its plain version at the garden shapes, timed
     with CUDA events beside its bound and the plain version's time.
The line before the last is the ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
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


def phase_parity(torch, dev):
    """BASELINE config 2 (100k, 800x800, SH3): kernels against plain."""
    from tpusplat_torch import RenderConfig, look_at_camera, random_scene
    from tpusplat_torch.ops import binning, rasterize
    from tpusplat_torch.ops.emission import emit_instances
    from tpusplat_torch.ops.preprocess import ProcessedGaussians, preprocess

    w = h = 800
    params = random_scene(100_000, seed=0, sh_degree=3, scale_range=(0.004, 0.04),
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

    b_gpu = binning.bin_and_sort(pg, w, h, cfg)
    pg_cpu = ProcessedGaussians(**{f.name: getattr(pg, f.name).cpu()
                                   for f in dataclasses.fields(pg)})
    b_cpu = binning.bin_and_sort(pg_cpu, w, h, cfg)
    for f in dataclasses.fields(b_gpu):
        check_equal(f"bin_and_sort {f.name}", getattr(b_gpu, f.name), getattr(b_cpu, f.name))
    if int(b_gpu.overflow):
        fail("capacity overflow at 100k")

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
    log(phase="parity_100k", n=n, width=w, height=h, capacity=cap,
        num_instances=int(b_gpu.num_instances), max_tile_count=max_count,
        emission="bit-equal", bin_and_sort="bit-equal vs CPU",
        forward_max_abs_err_image=err_img, forward_max_abs_err_transmittance=err_t)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the GPU",
              file=sys.stderr)
        return 1

    from tpusplat_torch import RenderConfig, look_at_camera, random_scene
    from tpusplat_torch.ops import _build, binning, emission, rasterize
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.render import render_auto, render_profiled

    # Parity precision: the plain blend's colour sum is a matmul.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    report = _build.build(verbose=True)
    log(phase="build", seconds=time.perf_counter() - t0,
        kernels={k: dict(seconds=v["seconds"],
                         ptxas=[ln.strip() for ln in v["log"].splitlines()
                                if "registers" in ln or "spill" in ln])
                 for k, v in report.items()})

    with torch.no_grad():
        phase_parity(torch, dev)

        # ---- garden serving (bench.py's garden configuration) ----
        n, w, h = 1_400_000, 1920, 1080
        params = random_scene(n, seed=0, sh_degree=3, scale_range=(0.002, 0.02),
                              extent=4.0, device=dev)
        cams = orbit_cameras(look_at_camera, [0.0, 0.5, 9.0], [0.0, 0.0, 0.0], w, h,
                             60.0, 3, dev)
        cfg = RenderConfig(sh_degree=3, capacity_mult=4, max_per_tile=4096,
                           tight_radius=True)
        needed = int(preprocess(params, cams[0], cfg).ntiles.sum())
        cfg = dataclasses.replace(cfg, capacity=int(needed * 1.05))
        tiles_x, tiles_y = cfg.tile_grid(w, h)

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

        # ---- kernels against plain versions at the garden shapes ----
        cap = cfg.instance_capacity(n)
        pg = preprocess(params, cams[0], cfg)
        meta = binning.depth_sorted_meta(pg)
        em_args = (*meta, tiles_x, cap, 0, n)
        got = emission.emit_instances(*em_args)
        want = binning.expand_instances_sorted(*em_args)
        for name, a, b in zip(("tile", "gid", "total", "overflow"), got, want):
            check_equal(f"garden emission {name}", a, b)
        em_err = max(float((a.long() - b.long()).abs().max()) for a, b in zip(got[:2], want[:2]))
        em_ms = cuda_ms(torch, lambda: emission.emit_instances(*em_args), reps=20)
        em_plain_ms = cuda_ms(torch, lambda: binning.expand_instances_sorted(*em_args), reps=5)
        em_bytes = 4 * (5 * n + 2 * cap)  # five [N] int32 meta in, two [C] int32 out
        em_ops = cap * (4 * math.ceil(math.log2(n)) + 10)  # search + division per slot

        binned = binning.bin_and_sort(pg, w, h, cfg)
        attr = rasterize.pack_instances(pg, binned)
        num_inst = int(binned.num_instances)
        max_count = int((binned.tile_end - binned.tile_start).max())
        cfg_p = dataclasses.replace(cfg, max_per_tile=max(cfg.max_per_tile, max_count))
        fw_args = (attr, binned.tile_start, binned.tile_end, tiles_x, 0, w, h, cfg_p)
        img, tmap, _ = rasterize.forward_blend(*fw_args)
        img_p, tmap_p, _ = rasterize.blend_plain(*fw_args)
        fw_err = max(check_close("garden forward image", img, img_p, atol=3e-5, rtol=1e-4),
                     check_close("garden forward transmittance", tmap, tmap_p, atol=3e-5))
        fw_ms = cuda_ms(torch, lambda: rasterize.forward_blend(*fw_args), reps=20)
        fw_plain_ms = cuda_ms(torch, lambda: rasterize.blend_plain(*fw_args), reps=2)
        npx = cfg.tile_w * cfg.tile_h
        fw_flops = num_inst * npx * BLEND_FLOPS_PER_PAIR
        fw_bytes = 4 * (9 * num_inst + 2 * tiles_x * tiles_y + 4 * w * h)

    def bound(nbytes, nops):
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, nops / PEAK_FP32_FLOPS * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    em_bound, em_by = bound(em_bytes, em_ops)
    fw_bound, fw_by = bound(fw_bytes, fw_flops)
    log(phase="garden", n=n, width=w, height=h, capacity=cap, frames_ms=frames_ms,
        num_instances=instances, max_tile_count=max_count, stage_ms=stage_ms,
        launches=launches,
        kernel_ms=dict(emission=dict(ms=em_ms, bound_ms=em_bound, plain_ms=em_plain_ms),
                       forward_blend=dict(ms=fw_ms, bound_ms=fw_bound,
                                          plain_ms=fw_plain_ms)))
    kernels = [
        dict(name="emission", route="cuda", source="tpusplat_torch/csrc/emission.cu",
             replaces="tpusplat/ops/emission.py:76", launches=launches["emission"],
             max_abs_err=em_err, ms=em_ms, plain_ms=em_plain_ms, bound_ms=em_bound,
             bound_by=em_by, library_ms=None),
        dict(name="forward_blend", route="cuda",
             source="tpusplat_torch/csrc/rasterize_forward.cu",
             replaces="tpusplat/ops/rasterize_pallas.py:220",
             launches=launches["forward_blend"], max_abs_err=fw_err, ms=fw_ms,
             plain_ms=fw_plain_ms, bound_ms=fw_bound, bound_by=fw_by, library_ms=None),
    ]
    if any(k["launches"] < len(cams) for k in kernels):
        fail(f"launch counts {launches} below one a frame")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
