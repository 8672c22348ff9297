"""The ``train_2dgs`` kind rehearsed through the harness on the CPU at a tiny
size (the port's plain surfel path): its check passes on the sound port and
fails on each fault planted in it, with the cell's own limits; and the work
model's counts."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

HERE = os.path.join(ROOT, "splatbench")
TINY = dict(name="tiny2dgs", gaussians=1500, width=64, height=48, views=6,
            scale_range=[0.05, 0.3])
MIX = dict(warmup_s=0.2, traced_steps=2, loss_reps=2)
CELL = "tiny2dgs-train"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark holding the cell tiny2dgs-train, on a tiny
    surfel configuration, with garden2dgs-train's limits."""
    root = tmp_path_factory.mktemp("tiny2dgs")
    dst = root / "splatbench"
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    conf = json.load(open(dst / "configs" / "garden-2dgs.json"))
    conf.update(TINY)
    json.dump(conf, open(dst / "configs" / "tiny2dgs.json", "w"))
    mix = json.load(open(dst / "traffic" / "train-2dgs.json"))
    mix.update(MIX)
    json.dump(mix, open(dst / "traffic" / "tiny-2dgs.json", "w"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"] = [dict(name=CELL, config="tiny2dgs", traffic="tiny-2dgs", chips=1,
                               why="a test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL] if "garden2dgs-train" in m["workloads"] else []
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    shutil.copy(dst / "limits" / "garden2dgs-train.json", dst / "limits" / f"{CELL}.json")
    return root


def rehearse(root, seed=2**31 + 9, trace=0, fault=None):
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}", OMP_NUM_THREADS="1")
    args = [sys.executable, os.path.join(HERE, "tests", "rehearse_2dgs.py"), str(root), CELL,
            str(seed), "0.5", str(trace)] + ([fault] if fault else [])
    res = subprocess.run(args, capture_output=True, text=True, env=env, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_sound_run_is_correct(tiny):
    out = rehearse(tiny)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_mpix_s", "setup_s"}


def test_traced_run_reads_the_host_spans(tiny):
    """On the CPU the device's readers stay silent; the loss layer's reports."""
    out = rehearse(tiny, trace=1)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"loss_ms.train"}


@pytest.mark.parametrize("fault", ["no_filter", "no_flip", "centre_depth", "drop_am2"])
def test_planted_fault_is_not_correct(tiny, fault):
    out = rehearse(tiny, fault=fault)
    assert not out["correct"], out["checks"]


def test_work_model_counts():
    from splatbench import workmodel as wm
    from splatbench import workmodel_2dgs as wm2

    pairs = dict(evaluated=1000, contributing=400)
    assert wm2.blend_fwd(pairs, 10, 4) == (49 * 1000 + 35 * 400, 72 * 10 + 48 * 4)
    assert wm2.blend_bwd(pairs, 10, 4) == (132 * 400, 144 * 10 + 88 * 4)
    assert wm2.preprocess_fwd(2) == (758, 666) and wm2.preprocess_bwd(1) == (758, 536)
    step = wm2.train_step_ops(3, 5, pairs, 7)
    assert step == (3 * (379 + 758) + 49 * 1000 + 35 * 400 + 132 * 400
                    + 7 * (3 * (wm.LOSS_FWD + wm.LOSS_BWD) + 39 + 78)
                    + 5 * (58 * wm.ADAM + wm.STATS))
