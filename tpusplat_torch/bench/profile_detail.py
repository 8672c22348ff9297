"""Per-stage profile at production (garden) scale (counterpart of
``tpusplat/bench/profile_detail.py``).

The stage table is the program's own. A compiled frame (``compile_render``)
and a compiled train step (``compile_train_step``), what the viewer and
the trainer replay, are captured and replayed ``reps`` times each; every
replay stamps its stages (``tpusplat_torch.trace``), and the table gives
the median over the replays of each stage's ms under the names PERF.md
and the benchmark's cells use (preprocess, binning, blend, loss,
blend_bwd, preprocess_bwd, adam, writeback), of the gap from one replay's
``end`` to the next one's first stamp, and of the whole replay
(``unit``). The stamps read the device clock on the card and the host
clock on the CPU (a rehearsal); the result names which (``clock``). First
the emission kernel is held bit for bit to its plain version on the
scene. Then one ``torch.profiler`` window over three replays of the
compiled train step (``_timing.profile_window``) gives what the stages
cannot: the window's ms, the device's busy ms, the idle share, the
launches a step, the ten kernels with the most device time, and the idle
share the busy time leaves in the same replays unprofiled. Prints a table
to stderr and one JSON line.

    python -m tpusplat_torch.bench.profile_detail [garden|bicycle|mid|small]
    python -m tpusplat_torch.bench.profile_detail strip [n_shards]

(strip: each stage of one strip of tiles_y / n_shards tile rows at garden
scale, the per-card split of the tile-sharded path, timed alone by CUDA
events: that path runs eagerly and has no stamps.)
"""

from __future__ import annotations

import dataclasses
import statistics
import sys

import torch

from tpusplat_torch.bench._timing import clock, emit, profile_window, require_card, time_ms

CONFIGS = dict(
    garden=dict(n=1_400_000, w=1920, h=1080, sh=3, cap=4, srange=(0.002, 0.02)),
    bicycle=dict(n=6_000_000, w=1600, h=1063, sh=3, cap=3, srange=(0.0012, 0.012)),
    mid=dict(n=100_000, w=800, h=800, sh=3, cap=8, srange=(0.004, 0.04)),
    small=dict(n=10_000, w=256, h=256, sh=0, cap=8, srange=(0.004, 0.04)),
)
EYE, TARGET, FOV = [0.0, 0.5, 9.0], [0.0, 0.0, 0.0], 60.0


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


def check_emission(params, cam, cfg) -> int:
    """The emission kernel held bit for bit to ``expand_instances_sorted``
    on the scene's frame, and no capacity overflow; the instance count."""
    from tpusplat_torch.ops import binning
    from tpusplat_torch.ops.emission import emit_instances
    from tpusplat_torch.ops.preprocess import preprocess

    n = params.num_gaussians
    tiles_x, _ = cfg.tile_grid(cam.width, cam.height)
    with torch.no_grad():
        meta = binning.depth_sorted_meta(preprocess(params, cam, cfg))
        args = (*meta, tiles_x, cfg.instance_capacity(n), 0, n)
        em = emit_instances(*args)
        _same("the emission", em, binning.expand_instances_sorted(*args))
    if int(em[3]):
        raise AssertionError(f"profile_detail: capacity overflow {int(em[3])}")
    return int(em[2])


def stamped_stages(compiled, call, reps: int, device):
    """``call()``, a call of the compiled step ``compiled``, once (the
    capture) and then ``reps`` times; from the replays' stamps, the median
    of each stage's ms, of the gap between replays and of a whole replay
    (first stamp to ``end``), and the stamps' clock."""
    from tpusplat_torch import trace

    for _ in range(reps + 1):
        call()
    stamps = trace.read(device)
    units = stamps.units(compiled.tag)[-reps:]
    if len(units) != reps:
        raise AssertionError(f"profile_detail: {len(units)} stamped replays, not {reps}")
    names = [name for name, _ in units[-1].marks[:-1]]
    res = {name: statistics.median(u.stage_ms()[name] for u in units) for name in names}
    res["gap"] = statistics.median(trace.gaps(units))
    res["unit"] = statistics.median((u.end_ns - u.start_ns) / 1e6 for u in units)
    return res, stamps.clock


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


def _stage_table(frame: dict, train: dict) -> None:
    print(f"{'stage (ms)':<15} {'frame':>10} {'train':>10}", file=sys.stderr)
    for name in train:
        shown = f"{frame[name]:10.3f}" if name in frame else " " * 10
        print(f"{name:<15} {shown} {train[name]:10.3f}", file=sys.stderr)
    sys.stderr.flush()


def run(conf="garden", device="cuda", reps: int = 5, window_steps: int = 3) -> dict:
    """The stage table of a compiled frame and a compiled train step from
    their stamps, the emission's check and the profiler window over the
    compiled train step at one configuration."""
    from tpusplat_torch.render import compile_render
    from tpusplat_torch.train.step import (
        compile_train_step, create_train_state, make_optimizer,
    )

    params, cam, cfg = scene(conf, device)
    w, h = cam.width, cam.height
    res = dict(config=conf if isinstance(conf, str) else "custom",
               num_instances=check_emission(params, cam, cfg),
               capacity=cfg.instance_capacity(params.num_gaussians))
    render = compile_render()
    with torch.no_grad():
        res["frame"], res["clock"] = stamped_stages(render, lambda: render(params, cam, cfg),
                                                    reps, device)
    del render

    gen = torch.Generator(device=params.device).manual_seed(1)
    target = torch.rand((h, w, 3), generator=gen, device=params.device)
    opt = make_optimizer(scene_extent=4.0)
    step = compile_train_step()
    last = {"state": create_train_state(params)}

    def one():
        last["state"], last["metrics"] = step(last["state"], cam, target, cfg, opt)

    res["train"], _ = stamped_stages(step, one, reps, device)
    res["mpix_per_s"] = w * h / (res["train"]["unit"] * 1e-3) / 1e6
    _stage_table(res["frame"], res["train"])
    _table(res)
    win = profile_window(one, device, window_steps)
    m = last["metrics"]
    res["train_window"] = dict(win, overflow=int(m["capacity_overflow"])
                               + int(m["gauss_overflow"]))
    step.clear()
    return res


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
