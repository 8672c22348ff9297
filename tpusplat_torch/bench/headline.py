"""The headline harness (counterpart of ``bench.py``): forward and backward
render throughput of one configuration on the card, in Mpix/s.

    python -m tpusplat_torch.bench.headline
    BENCH_CONFIG=bicycle python -m tpusplat_torch.bench.headline

The north-star metric of ``BASELINE.json`` is Mpix/s a card at 1080p,
forward and backward, on the 1.4M-Gaussian garden scene; ``vs_baseline``
is over 62.2 Mpix/s, 30 frames a second at 1080p.

**The step** is ``bench.py``'s: ``split_trainable``, ``render_stages`` of
the merged parameters, the mean of the squared image (against a black
target) and its gradient with respect to the five trainable fields by
``torch.autograd.grad``. There is no SSIM and no Adam, which the train step
(``train/step.py``) has. It returns the sum of the means' gradient, the
instance count and the capacity overflow; the forward-only step returns the
image's sum in the first place.

**The compiled step.** ``bench.py`` times ``jax.jit(step)``; the harness
times :func:`tpusplat_torch.compiled.compile_step` of ``step`` (and of
``forward_step``), ``cfg`` static: on the card a CUDA graph captured at the
warm call and replayed by every later one. The warm call's line reads
"capture+first run", as ``bench.py``'s reads "compile+first run". To time
the eager step, call :func:`measure` on ``step`` itself.

**The time** is ``bench.py``'s too: one warm call, then the host clock over
a run of ``max(1, iters // 4)`` calls and over one of ``iters + max(1,
iters // 4)``, each fenced by a synchronise, and ``dt = (t_big - t_small) /
iters``; so host time the card does not hide counts. ``_timing.host_ms``
takes the median of three such pairs and never returns 0 or less.
One more call after the timed runs must show no overflow, or the harness
raises. A line before the headline also gives the same step's CUDA-event
time (``_timing.time_ms``), so host time and device time can be read apart.

**The lines**, JSON, each with the device (the card's name and
``nvidia-smi``'s name and power limit): the step's detail (both times, the
instances, the capacity, the peak memory); for garden without
``BENCH_FWD_ONLY``, the viewer's detail and line (the forward alone, timed
the same way) and the strip's detail and line (the forward and backward of
each of eight strips measured on this card, and the eight-card frame they
project to with the exchange at 50% of the H100's NVLink rate, by
:func:`tpusplat_torch.bench.strip_projection.measure_strip_projection`);
last the headline, ``bench.py``'s four keys and metric string.

``bench.py``'s production line is not printed. Its ``mm_precision="default"``
selects single-pass bf16 matrix products in the Pallas blends; the port's
blends are fp32 CUDA-core kernels with no matrix product, and the MSE step
has no convolution, so the line would repeat the headline under another
name.

Environment (``bench.py``'s knobs):
  BENCH_CONFIG=garden|bicycle|mid|small  the configuration (default garden)
  BENCH_ITERS=N                          timed iterations (default 5)
  BENCH_FWD_ONLY=1                       the forward alone
  BENCH_STRIP=0                          no strip line
  BENCH_XLA=1                            refused: the port routes by tensor
                                         device (a CPU tensor takes the plain
                                         path)
and the TPUSPLAT_* overrides of ``RenderConfig.with_env_overrides``.
Exits 1 without a card, 2 on a refused or unknown setting.
"""

from __future__ import annotations

import functools
import os
import sys
import time

import torch

from tpusplat_torch.bench._timing import clock, emit, host_ms, require_card, time_ms
from tpusplat_torch.bench.profile_detail import CONFIGS, scene
from tpusplat_torch.compiled import compile_step
from tpusplat_torch.render import render_stages
from tpusplat_torch.train.step import merge_trainable, split_trainable

BASELINE_MPIX = 62.2  # 30 fps-equivalent at 1080p
STRIP_SHARDS = 8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def loss_and_grads(trainable: dict, alive, camera, cfg):
    """``bench.py``'s loss and its gradient: (loss, {field: gradient}, aux)."""
    leaves = {f: t.detach().requires_grad_(True) for f, t in trainable.items()}
    img, aux = render_stages(merge_trainable(leaves, alive), camera, cfg)
    loss = torch.mean(img ** 2)  # mean((img - target) ** 2), the target black
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads)), aux


def step(trainable: dict, alive, camera, cfg):
    """(sum of the means' gradient, num_instances, capacity_overflow)."""
    _, grads, aux = loss_and_grads(trainable, alive, camera, cfg)
    return grads["means"].sum(), aux["num_instances"], aux["capacity_overflow"]


@torch.no_grad()
def forward_step(trainable: dict, alive, camera, cfg):
    """(image sum, num_instances, capacity_overflow)."""
    img, aux = render_stages(merge_trainable(trainable, alive), camera, cfg)
    return img.sum(), aux["num_instances"], aux["capacity_overflow"]


def measure(fn, device, iters: int, what: str) -> dict:
    """The warm call, the differenced host time, the overflow check after it
    and the CUDA-event time of ``fn`` (a step bound to its inputs)."""
    t0 = time.perf_counter()
    out = fn()
    out[0].item()
    first_s = time.perf_counter() - t0
    log(f"{what}: capture+first run {first_s:.2f}s instances={int(out[1])} "
        f"overflow={int(out[2])}")
    if int(out[2]) > 0:
        log("WARNING: capacity overflow: raise capacity_mult")
    host = host_ms(fn, device, iters)
    final = fn()
    if int(final[2]) != 0:
        raise AssertionError(
            f"bench invalid: capacity overflow {int(final[2])} during timed runs")
    event_ms, _ = time_ms(fn, device, reps=iters)
    return dict(first_s=first_s, host_ms=host, event_ms=event_ms,
                event_clock=clock(device), num_instances=int(final[1]))


def metric_line(metric: str, mpix: float) -> dict:
    return {"metric": metric, "value": round(mpix, 2), "unit": "Mpix/s",
            "vs_baseline": round(mpix / BASELINE_MPIX, 3)}


def _peak_bytes(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def run(conf="garden", device="cuda", iters: int = 5, fwd_only: bool = False,
        strip: bool = True, inputs=None) -> list:
    """The harness at one configuration (a name of ``CONFIGS`` or a dict like
    its entries); returns the JSON lines it printed, the headline last.
    Garden without ``fwd_only`` adds the viewer line and, on the card with
    ``strip``, the strip line. ``inputs`` is a scene already made by
    :func:`scene`, (params, camera, cfg), which ``conf`` then only names."""
    device = torch.device(device)
    name = conf if isinstance(conf, str) else "custom"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params, cam, cfg = inputs or scene(conf, device)
    n, w, h = params.num_gaussians, cam.width, cam.height
    mpix_frame = w * h / 1e6
    capacity = cfg.instance_capacity(n)
    mode = "fwd" if fwd_only else "fwd+bwd"
    log(f"headline: device={device} config={name} n={n} {w}x{h} sh={cfg.sh_degree} "
        f"capacity={capacity} mode={mode} iters={iters}")
    trainable, alive = split_trainable(params)

    def compiled(fn):  # bench.py's jax.jit(step), cfg static, bound to its inputs
        return functools.partial(compile_step(fn, static_argnames=("cfg",)), trainable,
                                 alive, cam, cfg)

    bound = compiled(forward_step if fwd_only else step)
    lines = []

    def detail(what, m):
        lines.append(emit(dict(config=name, mode=what, n=n, width=w, height=h,
                               capacity=capacity, clock="host", iters=iters, **m,
                               peak_mem_bytes=_peak_bytes(device)), device))

    m = measure(bound, device, iters, mode)
    detail(mode, m)
    mpix = mpix_frame / (m["host_ms"] * 1e-3)
    log(f"{mode}: {m['host_ms']:.2f} ms/frame (events {m['event_ms']:.2f}) -> "
        f"{mpix:.1f} Mpix/s")
    if name == "garden" and not fwd_only:
        viewer = compiled(forward_step)
        mv = measure(viewer, device, iters, "viewer")
        detail("viewer", mv)
        mpix_v = mpix_frame / (mv["host_ms"] * 1e-3)
        log(f"viewer (fwd-only): {mv['host_ms']:.2f} ms/frame -> {mpix_v:.1f} Mpix/s "
            f"({1e3 / mv['host_ms']:.1f} fps)")
        lines.append(emit(metric_line(
            f"VIEWER fwd-only Mpix/s/chip ({name}: {n} gaussians @ {w}x{h})", mpix_v), device))
        if strip and device.type == "cuda":
            from tpusplat_torch.bench.strip_projection import measure_strip_projection

            sp = measure_strip_projection(params, cam, cfg, shards=STRIP_SHARDS,
                                          iters=max(3, iters // 2), t_full_ms=m["host_ms"])
            lines.append(emit(dict(config=name, mode="strip", shards=STRIP_SHARDS, **sp,
                                   peak_mem_bytes=_peak_bytes(device)), device))
            log(f"strip mode: per-strip fwd+bwd max {sp['strip_ms_max']:.2f} ms -> "
                f"{STRIP_SHARDS}-card projection {sp['mpix_per_s']:.1f} Mpix/s "
                f"({sp['scaling_eff_vs_1card'] * 100:.0f}% efficiency, NVLink @50%)")
            lines.append(emit(metric_line(
                f"STRIP {STRIP_SHARDS}-card NVLink projection Mpix/s ({name}, measured "
                "per-strip fwd+bwd, dense grad exchange, NVLink@50%)", sp["mpix_per_s"]),
                device))
    lines.append(emit(metric_line(
        f"{mode} Mpix/s/chip ({name}: {n} gaussians @ {w}x{h})", mpix), device))
    return lines


def main() -> int:
    if os.environ.get("BENCH_XLA", "") == "1":
        print("headline: BENCH_XLA=1 is not ported: tpusplat_torch routes by tensor device "
              "(a CPU tensor takes the plain path)", file=sys.stderr)
        return 2
    conf = os.environ.get("BENCH_CONFIG", "garden")
    if conf not in CONFIGS:
        print(f"headline: unknown BENCH_CONFIG {conf!r} (one of {sorted(CONFIGS)})",
              file=sys.stderr)
        return 2
    if not require_card("headline"):
        return 1
    run(conf, "cuda", iters=int(os.environ.get("BENCH_ITERS", "5")),
        fwd_only=os.environ.get("BENCH_FWD_ONLY", "") == "1",
        strip=os.environ.get("BENCH_STRIP", "1") != "0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
