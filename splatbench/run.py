"""Run one cell of the benchmark once and print its result line.

    python3 -m splatbench.run --workload garden-train --seed 7 --seconds 10 --trace 0

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything else
is found by name (``splatbench/README.md``): its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``
(read by the generator of its ``kind``, ``kinds/<kind>.py``), the limits of its check in
``limits/<workload>.json``, and each per-layer metric's reader in
``metrics/<metric>.py``. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` window (CUDA activity) over part of the measured loop.

The run needs as many CUDA devices as the cell asks for, and exits nonzero
without printing a result when they are not there, when the check cannot
run, or when JAX or the JAX package was loaded in this process. A cell of
several cards runs as a rank a card (``ranks.py``); this process is rank 0.
"""

from __future__ import annotations

import time

PROCESS_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Caches of compilers the port may use, at fixed paths inside the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "splatbench" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "splatbench" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusplat")

import torch  # noqa: E402

from splatbench import drive  # noqa: E402


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"splatbench: no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, key: str, workload: str, moved=None) -> list:
    """The entries of ``bench[key]`` that the cell reports: those that list
    it, or, without a ``workloads`` key, every cell (per-layer: every cell
    that reports the end-to-end metric it moves)."""
    out = []
    for m in bench[key]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif moved is None or m["moves"] in moved:
            out.append(m)
    return out


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"splatbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_line(dev, n: int) -> dict:
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=n,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)))


def prepare(workload: str, bench_path: Path | None = None):
    """(the benchmark, the cell, its configuration, traffic mix and limits)."""
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    w = cell(bench, workload)
    conf = load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return bench, w, conf, traffic, limits


def execute(workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
            bench_path: Path | None = None) -> dict:
    """One run of a cell: set-up, the window, the check. Returns the result
    line's object (without printing it). ``device="cpu"`` rehearses the run
    on the plain path, for the harness's own tests. A cell of several
    chips runs as that many ranks (``ranks.py``)."""
    bench, w, conf, traffic, limits = prepare(workload, bench_path)
    if w["chips"] > 1:
        from splatbench import ranks

        return ranks.execute(workload, seed, seconds, traced, device, bench_path,
                             started=PROCESS_START)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    run = drive.Run(conf=conf, traffic=traffic, seed=seed, seconds=seconds, traced=traced,
                    device=dev)
    mix = drive.load_kind(traffic["kind"])(run)

    mix.setup()
    setup_s = time.monotonic() - PROCESS_START
    mix.window()
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {bad}")
    dev_line = device_line(dev, w["chips"])
    return finish(bench, workload, run, mix, limits, setup_s, dev_line)


def finish(bench: dict, workload: str, run, mix, limits: dict, setup_s: float,
           dev_line: dict) -> dict:
    """After the window: free the program, check it against the reference
    and read the metrics. Returns the result line's object."""
    traced = run.traced
    mix.free()
    if traced:
        mix.loss_span()
    ref = mix.check()
    readings = mix.readings(ref)
    checks = {k: dict(value=v, limit=limits[k]) for k, v in readings.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    e2e = metrics_of(bench, "end_to_end", workload)
    values = dict(run.e2e, setup_s=setup_s)
    metrics = {}
    if traced:
        moved = {m["name"] for m in e2e}
        for m in metrics_of(bench, "per_layer", workload, moved):
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        dev_line.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
    else:
        for m in e2e:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    out = dict(correct=correct, attempted=run.attempted, failed=run.failed, metrics=metrics,
               device=dev_line)
    if traced:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    drive.log(workload=workload, seed=run.seed, window_s=run.window_s, setup_s=setup_s,
              **run.notes)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("splatbench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    torch.set_num_threads(2)  # the host only dispatches; few threads keep it steady
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"splatbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
