"""GPU-executed correctness gate (counterpart of ``tpusplat/bench/tpu_gate.py``).

Runs on the card (refuses to certify anything else) and holds the CUDA
kernels against two oracles, at the JAX gate's sizes and tolerances:

  1. 100k Gaussians at 800x800, SH3 (BASELINE config 2): the image and the
     five parameter gradients of the CUDA path against the plain path (the
     plain versions of every kernel, composed by :func:`render_plain`, on
     the same card); and the production block (``mm_precision="default"``,
     tight radius), which has no effect in the port but runs and is held to
     the production bounds;
  2. the strip path at 50k/640x512, SH3, 4 strips (row0 > 0, strip
     compaction): each strip against a crop of the whole frame, and the sum
     of the strips' gradients against the whole frame's;
  3. 6k at 128x128, SH0: the CUDA path against autodiff of the naive
     O(N * pixels) :func:`tpusplat_torch.ops.golden.golden_render`, an
     oracle with none of the pipeline's machinery;
  4. the compact gradient exchange at 50k/640x512, SH2, 4 strips: one shard
     through ``exchange_render_emulated`` (gid sort, streamed-target
     reduce, multi-range owner reduce) against the dense strip pipeline.

Gradients are compared normalised by the oracle's largest magnitude
(:func:`grad_diffs`). Prints a table to stderr and one JSON line with every
diff, ``pass`` and the tolerances; exit code 0 when every check passed, 1
when one failed, 2 (and ``{"skipped": true, ...}``) without a card: a
skipped run is not a pass.

    python -m tpusplat_torch.bench.gpu_gate
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

from tpusplat_torch.bench._timing import device_info
from tpusplat_torch.train.step import TRAINABLE

# The JAX gate's tolerances (tpu_gate.py:37-45).
IMG_ATOL = 3e-5  # absolute: images are in [0, 1]
GRAD_ATOL = 1e-4  # relative to the parameter's gradient scale
GOLDEN_IMG_ATOL = 1e-4  # independent oracle, fp reassociation differs more
GOLDEN_GRAD_ATOL = 5e-4
PROD_IMG_ATOL = 2e-2
PROD_GRAD_ATOL = 5e-2


def grad_diffs(g_ref: dict, g_test: dict) -> dict:
    """Per field: max |g_test - g_ref| / (max |g_ref| + 1e-12), in float64."""
    out = {}
    for f in TRAINABLE:
        a = np.asarray(torch.as_tensor(g_ref[f]).detach().cpu(), np.float64)
        b = np.asarray(torch.as_tensor(g_test[f]).detach().cpu(), np.float64)
        out[f] = float(np.abs(b - a).max() / (np.abs(a).max() + 1e-12))
    return out


def _img_diff(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


def _scene(n, w, h, sh, seed, eye, device):
    from tpusplat_torch import look_at_camera, random_scene

    params = random_scene(n, seed=seed, sh_degree=sh, scale_range=(0.004, 0.04), extent=4.0,
                          device=device)
    cam = look_at_camera(eye, [0.0, 0.0, 0.0], w, h, fov_deg=60.0, device=device)
    return params, cam


def _grads(render, params, loss_fn):
    """(image, d loss / d the five trainable tensors) of ``loss_fn(render(p))``."""
    leaves = {f: getattr(params, f).detach().requires_grad_(True) for f in TRAINABLE}
    img = render(dataclasses.replace(params, **leaves))
    g = torch.autograd.grad(loss_fn(img), [leaves[f] for f in TRAINABLE])
    return img.detach(), dict(zip(TRAINABLE, g))


def _target(h, w, device):
    return torch.tensor(np.random.default_rng(0).uniform(0, 1, (h, w, 3)), dtype=torch.float32,
                        device=device)


def render_plain(params, cam, cfg):
    """The frame through the plain version of every kernel, on any device:
    the plain emission, autograd's gather and the plain blend (the XLA path
    of the JAX gate). Returns (img, aux)."""
    from tpusplat_torch.ops import binning
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.ops.rasterize import blend_plain

    n, w, h = params.num_gaussians, cam.width, cam.height
    tiles_x, tiles_y = cfg.tile_grid(w, h)
    pg = preprocess(params, cam, cfg)
    meta = binning.depth_sorted_meta(pg)
    tile, gid, total, overflow, _ = binning.expand_instances_sorted(
        *meta, tiles_x, cfg.instance_capacity(n), 0, n)
    tile_s, perm = torch.sort(tile, stable=True)
    edges = torch.arange(tiles_x * tiles_y + 1, dtype=torch.int32, device=tile.device)
    bounds = torch.searchsorted(tile_s, edges, out_int32=True)
    table = torch.cat([pg.uv.T, pg.conic.T, pg.opacity[None, :], pg.color.T], dim=0)
    attr = table.index_select(1, torch.clamp_max(gid[perm], n - 1))
    img, _, tile_overflow = blend_plain(attr, bounds[:-1], bounds[1:], tiles_x, 0, w, h, cfg)
    return img, dict(capacity_overflow=overflow, tile_overflow=tile_overflow,
                     num_instances=total)


def check_cuda_vs_plain(n=100_000, w=800, h=800, sh=3, seed=3, device="cuda"):
    """The CUDA path against the plain path, and the production block."""
    from tpusplat_torch import RenderConfig
    from tpusplat_torch.render import render_stages

    params, cam = _scene(n, w, h, sh, seed, [0.0, 0.5, 9.0], device)
    cfg = RenderConfig(sh_degree=sh, capacity_mult=8, max_per_tile=4096)
    cfg_prod = dataclasses.replace(cfg, mm_precision="default", tight_radius=True)
    target = _target(h, w, device)

    def mse(img):
        return torch.mean((img - target) ** 2)

    auxes = {}

    def kernels(c, key):
        def fn(p):
            img, auxes[key] = render_stages(p, cam, c)
            return img
        return fn

    def plain(p):
        img, auxes["plain"] = render_plain(p, cam, cfg)
        return img

    img_x, g_x = _grads(plain, params, mse)
    img_p, g_p = _grads(kernels(cfg, "cuda"), params, mse)
    img_pr, g_pr = _grads(kernels(cfg_prod, "prod"), params, mse)
    if int(auxes["cuda"]["capacity_overflow"]) or int(auxes["prod"]["capacity_overflow"]):
        raise AssertionError("gpu_gate: the gate scene overflowed its capacity")
    if int(auxes["plain"]["tile_overflow"]):
        raise AssertionError("gpu_gate: the gate scene overflowed max_per_tile")
    res = dict(img_max_abs_diff=_img_diff(img_p, img_x),
               num_instances=int(auxes["cuda"]["num_instances"]),
               grad_max_rel_diff=grad_diffs(g_x, g_p))
    ok = res["img_max_abs_diff"] <= IMG_ATOL and all(
        v <= GRAD_ATOL for v in res["grad_max_rel_diff"].values())
    res_prod = dict(img_max_abs_diff=_img_diff(img_pr, img_x),
                    num_instances=int(auxes["prod"]["num_instances"]),
                    grad_max_rel_diff=grad_diffs(g_x, g_pr))
    ok_prod = res_prod["img_max_abs_diff"] <= PROD_IMG_ATOL and all(
        v <= PROD_GRAD_ATOL for v in res_prod["grad_max_rel_diff"].values())
    return res, ok, res_prod, ok_prod


def check_strip_path(n=50_000, w=640, h=512, sh=3, seed=11, n_strips=4, device="cuda"):
    """Each strip (row0 > 0, strip compaction on) against a crop of the
    whole frame; the sum of the strips' loss gradients against the whole
    frame's."""
    from tpusplat_torch import RenderConfig
    from tpusplat_torch.ops.binning import bin_and_sort
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.ops.rasterize import rasterize
    from tpusplat_torch.render import render_stages

    params, cam = _scene(n, w, h, sh, seed, [0.0, 0.5, 7.0], device)
    cfg = RenderConfig(sh_degree=sh, capacity_mult=8)
    tiles_x, tiles_y = cfg.tile_grid(w, h)
    if tiles_y % n_strips:
        raise ValueError(f"gpu_gate: {tiles_y} tile rows do not split into {n_strips} strips")
    nrows = tiles_y // n_strips
    cap_strip = cfg.instance_capacity(n) // 2
    gcap = cfg.strip_gauss_capacity(n, nrows, tiles_y)

    def sq(img):
        return torch.sum(img * img) / (w * h * 3)

    full_aux = {}

    def full(p):
        img, full_aux["aux"] = render_stages(p, cam, cfg)
        return img

    img_full, g_full = _grads(full, params, sq)
    if int(full_aux["aux"]["capacity_overflow"]):
        raise AssertionError("gpu_gate: the strip scene overflowed its capacity")
    img_diff, g_sum = 0.0, None
    for s in range(n_strips):
        row0 = s * nrows

        def strip(p, row0=row0):
            pg = preprocess(p, cam, cfg)
            binned = bin_and_sort(pg, w, h, cfg, row0, nrows, cap_strip, gauss_capacity=gcap)
            if int(binned.overflow) or int(binned.gauss_overflow):
                raise AssertionError(f"gpu_gate: strip {s} overflowed its halved capacity")
            return rasterize(pg, binned, w, h, cfg, row0, nrows)[0]

        img_s, g = _grads(strip, params, sq)
        lo, hi = row0 * cfg.tile_h, min((row0 + nrows) * cfg.tile_h, h)
        img_diff = max(img_diff, _img_diff(img_s[:hi - lo], img_full[lo:hi]))
        g_sum = g if g_sum is None else {f: g_sum[f] + g[f] for f in TRAINABLE}
    res = dict(img_max_abs_diff=img_diff, n_strips=n_strips, gauss_capacity=gcap,
               grad_max_rel_diff=grad_diffs(g_full, g_sum))
    # The strip sums differ from the whole frame's only by the order of adds.
    ok = res["img_max_abs_diff"] <= IMG_ATOL and all(
        v <= GRAD_ATOL for v in res["grad_max_rel_diff"].values())
    return res, ok


def check_cuda_vs_golden(n=6_000, w=128, h=128, sh=0, seed=1, device="cuda"):
    """The CUDA path against autodiff of the naive golden blend. The golden
    oracle holds dense [N, pixels] tensors and their autograd residuals:
    6k x 128^2 keeps it to a few GB."""
    from tpusplat_torch import RenderConfig
    from tpusplat_torch.ops.golden import golden_render
    from tpusplat_torch.render import render_stages

    params, cam = _scene(n, w, h, sh, seed, [0.0, 0.5, 9.0], device)
    cfg = RenderConfig(sh_degree=sh, capacity_mult=8)
    target = _target(h, w, device)

    def mse(img):
        return torch.mean((img - target) ** 2)

    aux = {}

    def kernels(p):
        img, aux["aux"] = render_stages(p, cam, cfg)
        return img

    img_p, g_p = _grads(kernels, params, mse)
    if int(aux["aux"]["capacity_overflow"]):
        raise AssertionError("gpu_gate: the golden scene overflowed its capacity")
    img_g, g_g = _grads(lambda p: golden_render(p, cam, cfg), params, mse)
    res = dict(img_max_abs_diff=_img_diff(img_p, img_g),
               num_instances=int(aux["aux"]["num_instances"]),
               grad_max_rel_diff=grad_diffs(g_g, g_p))
    ok = res["img_max_abs_diff"] <= GOLDEN_IMG_ATOL and all(
        v <= GOLDEN_GRAD_ATOL for v in res["grad_max_rel_diff"].values())
    return res, ok


def check_compact_exchange(n=50_000, w=640, h=512, sh=2, seed=7, n_strips=4, device="cuda"):
    """With one shard the emulated exchange (an identity all-to-all) is a
    whole other gradient path: instance gradients, gid sort, streamed-target
    reduce into the one-bucket compact layout, multi-range owner reduce back
    to the dense table. Its parameter gradients must match the dense strip
    pipeline's."""
    from tpusplat_torch import RenderConfig
    from tpusplat_torch.ops.binning import bin_and_sort
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.ops.rasterize import rasterize
    from tpusplat_torch.parallel.compact_grad import (
        CompactStatic, exchange_render_emulated, pack_exchange_table,
    )

    params, cam = _scene(n, w, h, sh, seed, [0.0, 0.5, 7.0], device)
    cfg = RenderConfig(sh_degree=sh, capacity_mult=8)
    tiles_x, tiles_y = cfg.tile_grid(w, h)
    nrows = tiles_y // n_strips
    cap_strip = cfg.instance_capacity(n) // 2
    gcap = cfg.strip_gauss_capacity(n, nrows, tiles_y)
    if gcap is None:
        raise AssertionError("gpu_gate: the compact scene must activate strip compaction")
    st = CompactStatic(cfg=cfg, width=w, height=h, nrows=nrows, cap_shard=cap_strip, gcap=gcap,
                       n_total=n, n_local=n, n_shards=1)
    row0 = nrows  # a middle strip

    def sq(img):
        return torch.sum(img * img) / (w * h * 3)

    def dense(p):
        pg = preprocess(p, cam, cfg)
        binned = bin_and_sort(pg, w, h, cfg, row0, nrows, cap_strip, gauss_capacity=gcap)
        return rasterize(pg, binned, w, h, cfg, row0, nrows)[0]

    counters = {}

    def compact(p):
        table = pack_exchange_table(preprocess(p, cam, cfg))[None]
        img, counters["c"] = exchange_render_emulated(table, st, row0)
        return img

    _, g_d = _grads(dense, params, sq)
    _, g_c = _grads(compact, params, sq)
    c = counters["c"].sum(0)  # capacity, tile, gauss, a2a overflow
    if int(c[0]) or int(c[2]) or int(c[3]):
        raise AssertionError(f"gpu_gate: the compact exchange overflowed ({c.tolist()})")
    res = dict(gauss_capacity=gcap, grad_max_rel_diff=grad_diffs(g_d, g_c))
    ok = all(v <= GRAD_ATOL for v in res["grad_max_rel_diff"].values())
    return res, ok


def run(device="cuda", sizes: dict | None = None, log=sys.stderr) -> dict:
    """Every check; ``sizes`` overrides a check's keyword arguments by name
    (the tests rehearse at tiny sizes on the CPU). Returns the JSON dict."""
    sizes = sizes or {}
    # Parity precision: the plain blend's colour sum and the golden blend
    # are matrix products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {}

    def say(name, res, ok):
        print(f"  {name}: img max|diff| = {res.get('img_max_abs_diff', float('nan')):.3g}  "
              f"grads = {res['grad_max_rel_diff']}  pass={ok}", file=log, flush=True)
        out[name] = {**res, "pass": ok}
        return ok

    print("gpu_gate: strip path @ 50k/640x512 SH3 ...", file=log, flush=True)
    ok_s = say("strip_path_50k_640",
               *check_strip_path(device=device, **sizes.get("strip", {})))
    print("gpu_gate: compact-gradient exchange kernels @ 50k/640x512 ...", file=log, flush=True)
    ok_c = say("compact_exchange_50k_640",
               *check_compact_exchange(device=device, **sizes.get("compact", {})))
    print("gpu_gate: CUDA vs plain @ 800x800 SH3 (+production mode) ...", file=log, flush=True)
    res_x, ok_x, res_pr, ok_pr = check_cuda_vs_plain(device=device, **sizes.get("plain", {}))
    say("cuda_vs_plain_100k_800", res_x, ok_x)
    say("production_mm_default_vs_plain", res_pr, ok_pr)
    print("gpu_gate: CUDA vs golden autodiff @ 6k/128x128 SH0 ...", file=log, flush=True)
    ok_g = say("cuda_vs_golden_6k_128",
               *check_cuda_vs_golden(device=device, **sizes.get("golden", {})))
    out["pass"] = ok_x and ok_g and ok_s and ok_pr and ok_c
    out["tolerances"] = dict(img_atol=IMG_ATOL, grad_atol=GRAD_ATOL,
                             golden_img_atol=GOLDEN_IMG_ATOL, golden_grad_atol=GOLDEN_GRAD_ATOL,
                             prod_img_atol=PROD_IMG_ATOL, prod_grad_atol=PROD_GRAD_ATOL)
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"skipped": True, "device": {"kind": "cpu"}}))
        print("gpu_gate: no CUDA device; nothing certified", file=sys.stderr)
        # A skipped run is not a pass: a wrapper reading only the exit code
        # must be able to tell them apart.
        return 2
    out = {"device": device_info("cuda"), **run("cuda")}
    print(json.dumps(out), flush=True)
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
