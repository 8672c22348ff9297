"""The readings that the limits of a ``train_2dgs`` cell are set from, on the
card (``calibrate.py``'s counterpart for that kind): for each seed, the
numbers the check compares for the port against the reference; on the
control seeds also the control's (the reference in bfloat16, put in the
port's place) and each planted fault's (``reference_2dgs.FAULTS``: the
low-pass filter dropped, the normals not turned to the camera, each pair's
depth taken at the surfel's centre, the distortion's A m^2 term dropped;
the reference with the fault, put in the port's place). One JSON line a
seed.

    python3 -m splatbench.calibrate_2dgs --workload garden2dgs-train \\
        --seeds 1-12 --control-seeds 1-3

Set-up runs as a run's does, to the window; no window is run (the readings
are set-up's checked steps). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from splatbench import calibrate, drive, run as runner


def one(workload: str, seed: int, control: bool, device: str = "cuda") -> dict:
    _, _, conf, traffic, _ = runner.prepare(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    run = drive.Run(conf=conf, traffic=traffic, seed=seed, seconds=0.0, traced=False,
                    device=dev)
    mix = drive.load_kind(traffic["kind"])(run)
    t0 = time.perf_counter()
    mix.setup()
    mix.free()
    t1 = time.perf_counter()
    ref = mix.check()
    out = dict(workload=workload, seed=seed, program=mix.readings(ref),
               setup_s=t1 - t0, check_s=time.perf_counter() - t1, notes=run.notes,
               work=run.work)
    if not control:
        return out
    out["control"] = mix.compare(mix.check(torch.bfloat16), ref)
    out["faults"] = {f: mix.compare(mix.check(torch.float32, f), ref) for f in mix.FAULTS}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("splatbench.calibrate_2dgs", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=calibrate.seeds_arg, required=True)
    p.add_argument("--control-seeds", type=calibrate.seeds_arg, default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("splatbench.calibrate_2dgs: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(one(args.workload, seed, seed in args.control_seeds), default=str),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
