"""Per-stage profiler at production (garden) scale (counterpart of
``tpusplat/bench/profile_detail.py``).

Each sub-stage of binning and of the backward runs and is timed alone
(CUDA events, after a warm call), so that work goes to the true bottleneck.
Then one ``torch.profiler`` window (CPU and CUDA activities) over three
``train_step`` calls after a warm-up step gives what the stage times cannot:
the window's ms, the device's busy ms (the union of its kernel and copy
intervals), the idle share ``1 - busy / window``, the launches a step, and
the ten kernels with the most device time. The profiler's recording slows
the host's dispatch, so the same steps are timed again without it, and
``idle_share_unprofiled_est`` is the share of that step time the window's
busy time leaves. Prints a table to stderr and one JSON line.

    python -m tpusplat_torch.bench.profile_detail [garden|bicycle|mid|small]
    python -m tpusplat_torch.bench.profile_detail strip [n_shards]

(strip: the stage times of one strip of tiles_y / n_shards tile rows at
garden scale, the per-card split of the tile-sharded path.)
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from tpusplat_torch.bench._timing import clock, emit, require_card, sync, time_ms

CONFIGS = dict(
    garden=dict(n=1_400_000, w=1920, h=1080, sh=3, cap=4, srange=(0.002, 0.02)),
    bicycle=dict(n=6_000_000, w=1600, h=1063, sh=3, cap=3, srange=(0.0012, 0.012)),
    mid=dict(n=100_000, w=800, h=800, sh=3, cap=8, srange=(0.004, 0.04)),
    small=dict(n=10_000, w=256, h=256, sh=0, cap=8, srange=(0.004, 0.04)),
)
EYE, TARGET, FOV = [0.0, 0.5, 9.0], [0.0, 0.0, 0.0], 60.0
TOP_KERNELS = 10


def scene(conf, device, seed: int = 0):
    """(params, camera, cfg) of a configuration (a name of ``CONFIGS`` or a
    dict like its entries): ``random_scene`` in a cube of half-side 4, the
    camera at (0, 0.5, 9) looking at the origin, fov 60, tight radius, the
    TPUSPLAT_* overrides, and the capacity from a preprocess probe x1.05
    (``bench.py``'s settling)."""
    from tpusplat_torch import RenderConfig, look_at_camera, random_scene
    from tpusplat_torch.ops.preprocess import preprocess

    s = CONFIGS[conf] if isinstance(conf, str) else conf
    params = random_scene(s["n"], seed=seed, sh_degree=s["sh"], scale_range=s["srange"],
                          extent=4.0, device=device)
    cam = look_at_camera(EYE, TARGET, s["w"], s["h"], fov_deg=FOV, device=device)
    cfg = RenderConfig(sh_degree=s["sh"], capacity_mult=s["cap"], max_per_tile=4096,
                       tight_radius=True).with_env_overrides()
    with torch.no_grad():
        needed = int(preprocess(params, cam, cfg).ntiles.sum())
    return params, cam, dataclasses.replace(cfg, capacity=int(needed * 1.05))


def _same(name, got, want):
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"profile_detail: {name} differs from its plain version")


def stages(params, cam, cfg, device, reps: int = 5) -> dict:
    """Each stage of a frame and of its backward, timed alone."""
    from tpusplat_torch.ops import binning
    from tpusplat_torch.ops.emission import emit_instances
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.ops.rasterize import (
        backward_blend, forward_blend, pack_instances, sort_grad_rows,
    )
    from tpusplat_torch.ops.segment_reduce import segment_reduce
    from tpusplat_torch.render import render_stages

    n, w, h = params.num_gaussians, cam.width, cam.height
    capacity = cfg.instance_capacity(n)
    tiles_x, tiles_y = cfg.tile_grid(w, h)
    num_tiles = tiles_x * tiles_y
    res: dict = {}

    def t(fn):
        return time_ms(fn, device, reps)

    with torch.no_grad():
        res["preprocess_fwd"], pg = t(lambda: preprocess(params, cam, cfg))
        res["depth_argsort_N"], meta = t(lambda: binning.depth_sorted_meta(pg))
        res["expand_instances"], em = t(lambda: emit_instances(*meta, tiles_x, capacity, 0, n))
        res["expand_ref"], em_ref = t(
            lambda: binning.expand_instances_sorted(*meta, tiles_x, capacity, 0, n))
        _same("the emission", em, em_ref)

        def tile_sort():
            tile_s, perm = torch.sort(em[0], stable=True)
            return tile_s, em[1][perm]

        res["tile_sort_C"], (tile_s, _) = t(tile_sort)
        edges = torch.arange(num_tiles + 1, dtype=torch.int32, device=tile_s.device)
        res["tile_boundaries"], _ = t(lambda: torch.searchsorted(tile_s, edges, out_int32=True))
        res["bin_and_sort_total"], binned = t(lambda: binning.bin_and_sort(pg, w, h, cfg))
        res["pack_gather"], attr = t(lambda: pack_instances(pg, binned))
        starts, ends = binned.tile_start, binned.tile_end
        res["raster_fwd_kernel"], (img, tmap, _) = t(
            lambda: forward_blend(attr, starts, ends, tiles_x, 0, w, h, cfg))
        d_img = torch.full_like(img, 1.0 / (w * h * 3))
        d_tmap = torch.zeros_like(tmap)
        res["raster_bwd_kernel"], d_attr = t(
            lambda: backward_blend(attr, starts, ends, img, tmap, d_img, d_tmap, tiles_x, 0, w,
                                   h, cfg))
        res["bwd_grad_sort_by_gid"], sorted_ = t(
            lambda: sort_grad_rows(d_attr, binned.gauss_id, n))
        res["bwd_segment_reduce"], _ = t(lambda: segment_reduce(*sorted_))
        res["e2e_fwd"], _ = t(lambda: render_stages(params, cam, cfg))

    def fwd_bwd():
        leaves = {f: getattr(params, f).detach().requires_grad_(True)
                  for f in ("means", "log_scales", "quats", "opacities", "sh")}
        img, _ = render_stages(dataclasses.replace(params, **leaves), cam, cfg)
        return torch.autograd.grad(torch.mean(img * img), list(leaves.values()))

    res["e2e_fwd_bwd"], _ = t(fwd_bwd)
    res["num_instances"] = int(binned.num_instances)
    res["capacity"] = capacity
    res["mpix_per_s"] = w * h / (res["e2e_fwd_bwd"] * 1e-3) / 1e6
    if int(binned.overflow):
        raise AssertionError(f"profile_detail: capacity overflow {int(binned.overflow)}")
    return res


def _merged_ms(intervals, lo, hi) -> float:
    """Length (ms) of the union of [start, end) us intervals clipped to
    [lo, hi)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def profile_window(fn, device, steps: int = 3) -> dict:
    """One ``torch.profiler`` window over ``steps`` calls of ``fn`` (warmed
    by the caller): window ms, device-busy ms, idle share, launches a call
    and the top kernels by device time; then the same calls unprofiled
    (CUDA events), and the idle share that the window's busy time leaves in
    them. On the CPU (a rehearsal) the trace holds no device activity, and
    the result says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync(device)
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function("window"):
            for _ in range(steps):
                fn()
            sync(device)
    events = prof.events()
    win = next(e for e in events if e.name == "window" and e.device_type == DeviceType.CPU)
    lo, hi = win.time_range.start, win.time_range.end
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False) and e.name != "window"]
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev_events)
    out = dict(steps=steps, window_ms=(hi - lo) / 1e3, profiler_device_events=len(dev_events))
    if not dev_events:
        out.update(device_busy_ms=None, idle_share=None,
                   note="the profiler recorded no device activity in the window")
        return out
    # The same calls without the profiler, whose host-side recording slows
    # the dispatch and so stretches the window: the device's kernel time a
    # call over this call time estimates the idle share of a plain call.
    step_ms, _ = time_ms(fn, device, steps, 0)
    busy = _merged_ms([(e.time_range.start, e.time_range.end) for e in dev_events], lo, hi)
    by_name: dict = {}
    for e in dev_events:
        if e.name.startswith(("Memcpy", "Memset")):
            continue
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    out.update(
        device_busy_ms=busy, idle_share=1.0 - busy / out["window_ms"],
        step_ms_unprofiled=step_ms,
        idle_share_unprofiled_est=max(0.0, 1.0 - busy / steps / step_ms),
        kernel_launches_per_step=(len(dev_events) - copies) / steps,
        copies_per_step=copies / steps,
        device_ms_per_step=sum(ms for ms, _ in by_name.values()) / steps,
        top_kernels=[dict(name=k[:160], ms_per_step=v[0] / steps, calls_per_step=v[1] / steps)
                     for k, v in top])
    return out


def train_window(params, cam, cfg, device, steps: int = 3) -> dict:
    """:func:`profile_window` over ``steps`` train steps after a warm-up
    step, with the overflow of the last step."""
    from tpusplat_torch.train.step import create_train_state, make_optimizer, train_step

    gen = torch.Generator(device=params.device).manual_seed(1)
    target = torch.rand((cam.height, cam.width, 3), generator=gen, device=params.device)
    opt = make_optimizer(scene_extent=4.0)
    last = {}
    last["state"], _ = train_step(create_train_state(params), cam, target, cfg, opt)  # warm-up

    def one():
        last["state"], last["metrics"] = train_step(last["state"], cam, target, cfg, opt)

    out = profile_window(one, device, steps)
    m = last["metrics"]
    return dict(out, overflow=int(m["capacity_overflow"]) + int(m["gauss_overflow"]))


def strip_stages(params, cam, cfg, device, shards: int, reps: int = 5) -> dict:
    """Stage times of the third strip (row0 = 2 nrows) of ``shards`` at the
    strip's capacity (an even split x1.35, ``profile_detail.py:71``) with
    strip compaction: the per-card split of the tile-sharded path."""
    from tpusplat_torch.ops import binning
    from tpusplat_torch.ops.emission import emit_instances
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.ops.rasterize import (
        backward_blend, forward_blend, pack_instances, sort_grad_rows,
    )
    from tpusplat_torch.ops.segment_reduce import segment_reduce

    n, w, h = params.num_gaussians, cam.width, cam.height
    tiles_x, tiles_y = cfg.tile_grid(w, h)
    nrows = -(-tiles_y // shards)
    row0 = min(2, shards - 1) * nrows
    with torch.no_grad():
        pg = preprocess(params, cam, cfg)
        needed = int(pg.ntiles.sum())
        cap = max(1024, -(-int(needed / shards * 1.35) // 1024) * 1024)
        gcap = cfg.strip_gauss_capacity(n, nrows, tiles_y)
        res: dict = dict(nrows=nrows, row0=row0, cap_strip=cap, gauss_capacity=gcap)

        def t(fn):
            return time_ms(fn, device, reps)

        def dsort_meta():
            vis = binning.strip_visible(pg, row0, nrows) if gcap is not None else None
            meta = binning.depth_sorted_meta(pg, row0, nrows, vis)
            total = meta[1].sum()
            if gcap is not None:
                meta = tuple(m[:gcap] for m in meta)
            return meta, total

        res["depth_sort_meta"], (meta, total) = t(dsort_meta)
        res["emission"], (tile, gid, tot, ovf, govf) = t(
            lambda: emit_instances(*meta, tiles_x, cap, row0, n,
                                   total if gcap is not None else None))
        if int(ovf) or int(govf):
            raise AssertionError(f"profile_detail strip: overflow {int(ovf)} gauss {int(govf)}")
        res["strip_instances"] = int(tot)

        def tile_sort():
            tile_s, perm = torch.sort(tile, stable=True)
            return tile_s, gid[perm]

        res["tile_sort"], (tile_s, gid_s) = t(tile_sort)
        num_tiles = tiles_x * nrows
        edges = torch.arange(num_tiles + 1, dtype=torch.int32, device=tile_s.device)
        res["boundaries"], bounds = t(lambda: torch.searchsorted(tile_s, edges, out_int32=True))
        binned = binning.BinnedInstances(
            gauss_id=gid_s, tile_id=tile_s, tile_start=bounds[:-1], tile_end=bounds[1:],
            num_instances=tot, overflow=ovf, gauss_overflow=govf)
        res["pack_gather"], attr = t(lambda: pack_instances(pg, binned))
        crop_h = nrows * cfg.tile_h
        args = (attr, binned.tile_start, binned.tile_end, tiles_x, row0, w, crop_h, cfg)
        res["raster_fwd"], (img, tmap, _) = t(lambda: forward_blend(*args))
        d_img = torch.full_like(img, 1.0 / (w * h * 3))
        res["raster_bwd"], d_attr = t(
            lambda: backward_blend(attr, binned.tile_start, binned.tile_end, img, tmap, d_img,
                                   torch.zeros_like(tmap), tiles_x, row0, w, crop_h, cfg))
        res["grad_sort"], sorted_ = t(lambda: sort_grad_rows(d_attr, gid_s, n))
        res["segment_reduce"], _ = t(lambda: segment_reduce(*sorted_))
    return res


def _table(res: dict) -> None:
    width = max(len(k) for k in res)
    for k, v in res.items():
        if isinstance(v, float):
            unit = "" if k == "mpix_per_s" else " ms"
            print(f"{k:<{width}} {v:10.3f}{unit}", file=sys.stderr)
        elif not isinstance(v, (dict, list)):
            print(f"{k:<{width}} {v!r:>10}", file=sys.stderr)
    sys.stderr.flush()


def run(conf="garden", device="cuda", reps: int = 5, window_steps: int = 3) -> dict:
    """Stage times and the profiler window at one configuration."""
    params, cam, cfg = scene(conf, device)
    res = stages(params, cam, cfg, device, reps)
    _table(res)
    res["train_window"] = train_window(params, cam, cfg, device, window_steps)
    return dict(config=conf if isinstance(conf, str) else "custom", clock=clock(device), **res)


def run_strip(shards: int = 8, device="cuda", conf="garden", reps: int = 5) -> dict:
    params, cam, cfg = scene(conf, device)
    res = strip_stages(params, cam, cfg, device, shards, reps)
    _table(res)
    return dict(config=f"strip {shards}", shards=shards, clock=clock(device), **res)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not require_card("profile_detail"):
        return 1
    conf = argv[0] if argv else "garden"
    if conf == "strip":
        res = run_strip(int(argv[1]) if len(argv) > 1 else 8)
    elif conf in CONFIGS:
        res = run(conf)
    else:
        print(f"profile_detail: unknown config {conf!r} (one of {sorted(CONFIGS)} or strip)",
              file=sys.stderr)
        return 2
    emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
