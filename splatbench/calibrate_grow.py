"""The readings that the limits of a ``train_grow`` cell are set from, on
the card (``calibrate.py``'s counterpart for that kind, which it would read
as a viewer): for each seed, the numbers the check compares for the port
against the reference; on the control seeds also the control's (the
reference in bfloat16, its steps and its round, put in the port's place)
and each planted fault's (``kinds/train_grow.py``'s ``Mix.FAULTS``: the round returning
its state, the statistics never accumulated, and the reference's round
cloning only, keeping the moments, or drawing zero noise, put in the port's
place). One JSON line a seed.

    python3 -m splatbench.calibrate_grow --workload garden-train-grow \\
        --seeds 1-12 --control-seeds 1-3

Set-up runs to the window's first step; no window is run (the readings are
set-up's checked steps and round). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from splatbench import calibrate, drive, run as runner


def one(workload: str, seed: int, control: bool, device: str = "cuda") -> dict:
    bench = runner.load_json(runner.ROOT / "BENCHMARK.json")
    w = runner.cell(bench, workload)
    conf = runner.load_json(runner.HERE / "configs" / f"{w['config']}.json")
    traffic = runner.load_json(runner.HERE / "traffic" / f"{w['traffic']}.json")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    run = drive.Run(conf=conf, traffic=traffic, seed=seed, seconds=0.0, traced=False,
                    device=dev)
    mix = drive.load_kind(traffic["kind"])(run)
    t0 = time.perf_counter()
    mix.setup()
    mix.alive_mean = float(mix.prog["post"]["alive"].sum())
    mix.free()
    t1 = time.perf_counter()
    ref = mix.check()
    out = dict(workload=workload, seed=seed, program=mix.readings(ref),
               setup_s=t1 - t0, check_s=time.perf_counter() - t1, notes=run.notes)
    if not control:
        return out
    out["control"] = mix.compare(mix.check(torch.bfloat16), ref)
    out["faults"] = {f: mix.compare(mix.fault_program(ref, f), ref) for f in mix.FAULTS}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("splatbench.calibrate_grow", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=calibrate.seeds_arg, required=True)
    p.add_argument("--control-seeds", type=calibrate.seeds_arg, default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("splatbench.calibrate_grow: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        res = one(args.workload, seed, seed in args.control_seeds)
        print(json.dumps(res, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
