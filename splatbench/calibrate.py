"""The readings that a cell's limits are set from, on the card: for each
seed, the numbers the check compares for the port against the reference;
on the control seeds also the control's (the reference in bfloat16, put in
the port's place) and each planted fault's (the reference with the fault,
put in the port's place). One JSON line a seed.

    python3 -m splatbench.calibrate --workload garden-train --seeds 1-12 \\
        --control-seeds 1-3 --seconds 3

Training cells take no window (their readings are the first steps of
set-up); viewer cells run a short window at the cell's own load, whose
kept frames are the ones compared. A cell of several cards starts its
ranks as a run does (``ranks.py``): every rank runs each seed's set-up,
rank 0 alone the reference, the control and the faults. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from splatbench import drive, inputs, reference, run as runner

CALIBRATE_TIMEOUT_S = 3600  # ranks wait while rank 0 runs the reference for every fault
VIEW_FAULTS = ("stale", "half_batch", "altered")


def seeds_arg(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def view_fault(mix, k: int, ref: dict, fault: str, dev) -> torch.Tensor:
    """The reference's frame ``k`` with a fault planted: ``stale`` the frame
    of the pose before, ``half_batch`` the lower half left black,
    ``altered`` 0.1 added to the first tile."""
    img = ref[k].clone()
    if fault == "stale":
        conf = mix.run.conf
        pose = mix.poses[(k - 1) % len(mix.poses)]
        with reference.full_fp32():
            p = inputs.make_scene(conf, mix.run.seed, dev)
            img, _ = reference.frame(p, reference.camera(inputs.pose_matrices(conf, pose),
                                                         torch.float32, dev), conf)
    elif fault == "half_batch":
        img[img.shape[0] // 2:] = 0.0
    elif fault == "altered":
        img[:reference.TILE, :reference.TILE] += 0.1
    return img


def one(workload: str, seed: int, seconds: float, control: bool, dev=None,
        rank: int = 0) -> dict | None:
    """One seed's readings (rank 0's; None on the other ranks)."""
    _, w, conf, traffic, _ = runner.prepare(workload)
    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None else dev
    run = drive.Run(conf=conf, traffic=traffic, seed=seed, seconds=seconds, traced=False,
                    device=dev, chips=w["chips"])
    mix = drive.load_kind(traffic["kind"])(run)
    t0 = time.perf_counter()
    mix.setup()
    if traffic["kind"] == "view":
        mix.window()
    mix.free()
    if rank:
        return None
    t1 = time.perf_counter()
    ref = mix.check()
    out = dict(workload=workload, seed=seed, program=mix.readings(ref),
               setup_s=t1 - t0, check_s=time.perf_counter() - t1, notes=run.notes)
    if not control:
        return out
    out["control"] = mix.compare(mix.check(torch.bfloat16), ref)
    if traffic["kind"] in ("train", "train_mesh"):
        out["faults"] = {f: mix.compare(mix.check(torch.float32, f), ref)
                         for f in reference.faults_for(conf)}
    else:
        out["faults"] = {f: mix.compare({k: view_fault(mix, k, ref, f, dev) for k in ref}, ref)
                         for f in VIEW_FAULTS}
    return out


def seeds(rank: int, world: int, dev, workload: str, seed_list: list, control_seeds: list,
          seconds: float):
    """Each seed's line, printed by rank 0 (a body for ``ranks.launch``;
    one card: rank 0 of 1, ``dev`` None for the current device)."""
    for seed in seed_list:
        res = one(workload, seed, seconds, seed in control_seeds, dev, rank)
        if res is not None:
            print(json.dumps(res), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("splatbench.calibrate", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds_arg, required=True)
    p.add_argument("--control-seeds", type=seeds_arg, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("splatbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    chips = runner.cell(runner.load_json(runner.ROOT / "BENCHMARK.json"), args.workload)["chips"]
    if chips > 1:
        from splatbench import ranks

        ranks.launch(seeds, chips, "cuda", (args.workload, args.seeds, args.control_seeds,
                                           args.seconds), timeout_s=CALIBRATE_TIMEOUT_S)
    else:
        seeds(0, 1, None, args.workload, args.seeds, args.control_seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
