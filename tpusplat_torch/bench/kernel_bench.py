"""Kernel-only bench at garden scale (counterpart of
``tpusplat/bench/kernel_bench.py``): the forward and backward blend kernels
alone, on the garden frame's slab and tile ranges.

For bisecting kernel variants without the pipeline around them: the inputs
are cached under ``build/tpusplat_torch/`` after the first run, keyed on
everything that shapes them (a stale cache after a scene or layout change
would skew the comparison). Prints one JSON line and the line
``RESULT fwd=...ms bwd=...ms``.

    python -m tpusplat_torch.bench.kernel_bench
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from tpusplat_torch.bench._timing import clock, emit, require_card, time_ms

CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "tpusplat_torch"


def inputs(conf="garden", device="cuda", cache_dir=CACHE_DIR):
    """(attr [9, C], starts, ends, cfg, camera, cache path, cache hit) of a
    configuration's frame."""
    from tpusplat_torch.bench.profile_detail import CONFIGS, scene
    from tpusplat_torch.ops.binning import bin_and_sort
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.ops.rasterize import ATTR_ROWS, pack_instances

    params, cam, cfg = scene(conf, device)
    s = CONFIGS[conf] if isinstance(conf, str) else conf
    key = (f"{s['n']}-{s['w']}-{s['h']}-{s['sh']}-{s['srange'][0]}-{s['srange'][1]}-"
           f"{cfg.capacity}-{ATTR_ROWS}-{cfg.tight_radius}-{cfg.tile_w}x{cfg.tile_h}")
    path = Path(cache_dir) / f"kbench_{key}.pt"
    hit = path.exists()
    if hit:
        z = torch.load(path, map_location=device)
        return z["attr"], z["starts"], z["ends"], cfg, cam, path, hit
    with torch.no_grad():
        pg = preprocess(params, cam, cfg)
        binned = bin_and_sort(pg, cam.width, cam.height, cfg)
        attr = pack_instances(pg, binned)
    if int(binned.overflow):
        raise AssertionError(f"kernel_bench: capacity overflow {int(binned.overflow)}")
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(attr=attr.cpu(), starts=binned.tile_start.cpu(),
                    ends=binned.tile_end.cpu()), path)
    return attr, binned.tile_start, binned.tile_end, cfg, cam, path, hit


def run(conf="garden", device="cuda", reps: int = 10, cache_dir=CACHE_DIR) -> dict:
    from tpusplat_torch.ops.rasterize import backward_blend, forward_blend

    attr, starts, ends, cfg, cam, path, hit = inputs(conf, device, cache_dir)
    w, h = cam.width, cam.height
    tiles_x, _ = cfg.tile_grid(w, h)
    with torch.no_grad():
        t_fwd, (img, tmap, _) = time_ms(
            lambda: forward_blend(attr, starts, ends, tiles_x, 0, w, h, cfg), device, reps)
        d_img = torch.full_like(img, 1.0 / (w * h * 3))
        d_tmap = torch.zeros_like(tmap)
        t_bwd, _ = time_ms(lambda: backward_blend(attr, starts, ends, img, tmap, d_img, d_tmap,
                                                  tiles_x, 0, w, h, cfg), device, reps)
    return dict(config=conf if isinstance(conf, str) else "custom", clock=clock(device),
                fwd_ms=t_fwd, bwd_ms=t_bwd, capacity=attr.shape[1], cache=str(path),
                cache_hit=hit)


def main(argv=None) -> int:
    if not require_card("kernel_bench"):
        return 1
    res = run()
    emit(res)
    print(f"RESULT fwd={res['fwd_ms']:.3f}ms bwd={res['bwd_ms']:.3f}ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
