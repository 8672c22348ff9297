"""Each kind of cell rehearsed through the harness on the CPU at a tiny
size (the port's plain path), its check passing on the sound port and
failing on each fault the cell can have; and a cell, a configuration, a
traffic mix and a per-layer metric added as new files only."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

HERE = os.path.join(ROOT, "splatbench")
TINY = dict(name="tiny", gaussians=2000, width=64, height=48, views=6,
            scale_range=[0.02, 0.2])
TRAIN = dict(warmup_s=0.2, traced_steps=2, loss_reps=2)
VIEW = dict(orbit=dict(radius=[9.0, 9.0], height=0.5, poses_per_rev=8), warmup_s=0.1,
            traced_frames=3, checked_frames=3)


def tiny_copy(tmp_path, limits_from=("garden-train", "garden-view")):
    """A copy of the benchmark holding the cells tiny-train and tiny-view,
    on a tiny configuration, with the limits of the cells named."""
    dst = tmp_path / "splatbench"
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    conf = json.load(open(dst / "configs" / "garden.json"))
    conf.update(TINY)
    json.dump(conf, open(dst / "configs" / "tiny.json", "w"))
    for kind, extra in (("train", TRAIN), ("view", VIEW)):
        mix = json.load(open(dst / "traffic" / f"{kind}.json"))
        mix.update(extra)
        json.dump(mix, open(dst / "traffic" / f"tiny{kind}.json", "w"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cells = dict(train="tiny-train", view="tiny-view")
    bench["workloads"] = [dict(name=v, config="tiny", traffic=f"tiny{k}", chips=1, why="a test")
                          for k, v in cells.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cells["train" if "train" in m["workloads"][0] else "view"]]
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    for cell, src in zip(cells.values(), limits_from):
        shutil.copy(dst / "limits" / f"{src}.json", dst / "limits" / f"{cell}.json")
    return tmp_path


def rehearse(root, workload, seed=2**31 + 5, seconds=0.5, trace=0, fault=None):
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}", OMP_NUM_THREADS="1")
    args = [sys.executable, os.path.join(HERE, "tests", "rehearse.py"), str(root), workload,
            str(seed), str(seconds), str(trace)] + ([fault] if fault else [])
    res = subprocess.run(args, capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", ["tiny-train", "tiny-view"])
def test_sound_run_is_correct(tiny, workload):
    out = rehearse(tiny, workload)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    e2e = dict(train={"train_mpix_s", "setup_s"}, view={"frame_ms", "frame_p95_ms", "setup_s"})
    assert set(out["metrics"]) == e2e[workload.split("-")[1]]
    assert all(m["value"] > 0 for m in out["metrics"].values())


def test_traced_run_reads_the_host_spans(tiny):
    """On the CPU the trace holds no device activity: the readers of the
    device trace stay silent and the spans' readers report."""
    out = rehearse(tiny, "tiny-train", trace=1)
    assert out["correct"]
    assert set(out["metrics"]) == {"loss_ms.train"}
    assert out["device"]["window_s"] > 0 and "breakdown" in out


@pytest.mark.parametrize("workload,fault", [
    ("tiny-train", "unchanged"), ("tiny-train", "half_batch"), ("tiny-train", "altered"),
    ("tiny-view", "unchanged"), ("tiny-view", "half_batch"), ("tiny-view", "altered"),
])
def test_broken_port_is_not_correct(tiny, workload, fault):
    out = rehearse(tiny, workload, fault=fault)
    assert not out["correct"], out["checks"]


def test_new_cell_from_new_files_only(tmp_path):
    """A configuration, a traffic mix on a new kind of generator, a
    per-layer metric and a cell added as new files and entries, with no file
    of the benchmark edited."""
    root = tiny_copy(tmp_path)
    sb = root / "splatbench"
    conf = json.load(open(sb / "configs" / "tiny.json"))
    conf.update(name="tiny2", gaussians=1500, width=48, height=32)
    json.dump(conf, open(sb / "configs" / "tiny2.json", "w"))
    (sb / "kinds" / "everyother.py").write_text(
        "from splatbench import drive\n\n\n"
        "class Mix(drive.load_kind('view')):\n"
        "    def setup(self):\n"
        "        super().setup()\n"
        "        self.poses = self.poses[::2]\n")
    mix = json.load(open(sb / "traffic" / "tinyview.json"))
    mix.update(kind="everyother", orbit=dict(radius=[6.0, 9.0], height=1.0, poses_per_rev=6))
    json.dump(mix, open(sb / "traffic" / "tinyorbit.json", "w"))
    (sb / "metrics" / "frames_per_window.view2.py").write_text(
        "def read(run):\n    return float(run.trace.units) if run.trace else None\n")
    shutil.copy(sb / "limits" / "tiny-view.json", sb / "limits" / "tiny2-orbit.json")
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["workloads"].append(dict(name="tiny2-orbit", config="tiny2", traffic="tinyorbit",
                                   chips=1, why="a test"))
    for m in bench["end_to_end"]:
        if m.get("workloads") and "tiny-view" in m["workloads"]:
            m["workloads"].append("tiny2-orbit")
    bench["per_layer"].append(dict(name="frames_per_window.view2", unit="frames",
                                   better="higher", source="program_counter", layer="entry",
                                   moves="frame_ms", workloads=["tiny2-orbit"]))
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    out = rehearse(root, "tiny2-orbit", trace=1)
    assert out["correct"]
    assert out["metrics"]["frames_per_window.view2"]["value"] >= 1
