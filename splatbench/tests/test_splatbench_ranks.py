"""A cell of several cards rehearsed through the harness's ranks
(``ranks.py``) and ``kinds/train_mesh.py``: four ranks over gloo on the
CPU at a tiny size, the check passing on the sound port and failing on
each fault the cell can have; a rank that fails in set-up ending the run
nonzero at once, never hanging it; and (marked ``card``) four ranks sharing
one card over gloo, so that one card can check the launcher."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import ROOT

HERE = os.path.join(ROOT, "splatbench")
CELL = "tiny-strip"
TINY = dict(name="tiny-strip", gaussians=2000, width=128, height=96, views=6,
            scale_range=[0.02, 0.2])
MIX = dict(warmup_s=0.3, traced_steps=2)
MESH_READERS = {"collective_ms.train": "ms", "mesh_skew.train": "%"}
REPORTED = {"train_mpix_s", "idle_share.train", "mfu.train", "device_ms.train", *MESH_READERS}


def strip_copy(tmp_path):
    """A copy of the benchmark whose one cell, tiny-strip, is the cell of
    four cards at a tiny size: garden-strip4's mesh, step and exchange
    setting, the train-strip mix, garden-train-strip4's limits, and the
    metrics such a cell reports (the readers of the mesh listed for it)."""
    dst = tmp_path / "splatbench"
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    conf = json.load(open(dst / "configs" / "garden-strip4.json"))
    conf.update(TINY)
    json.dump(conf, open(dst / "configs" / "tiny-strip.json", "w"))
    mix = json.load(open(dst / "traffic" / "train-strip.json"))
    mix.update(MIX)
    json.dump(mix, open(dst / "traffic" / "tiny-strip.json", "w"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"] = [dict(name=CELL, config="tiny-strip", traffic="tiny-strip", chips=4,
                               why="a test")]
    bench["per_layer"] = [m for m in bench["per_layer"] if m["name"] not in MESH_READERS]
    bench["per_layer"] += [dict(name=n, unit=u, better="lower", source="device_trace",
                                layer="collectives", moves="train_mpix_s")
                           for n, u in MESH_READERS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m or m["name"] in MESH_READERS:
            m["workloads"] = [CELL] if m["name"] in REPORTED else []
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    shutil.copy(dst / "limits" / "garden-train-strip4.json", dst / "limits" / f"{CELL}.json")
    return tmp_path


def rehearse(root, device="cpu", fault=None, seed=2**31 + 7, trace=0, check=True):
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}", OMP_NUM_THREADS="1")
    args = [sys.executable, os.path.join(HERE, "tests", "rehearse_ranks.py"), str(root), CELL,
            str(seed), "0.5", str(trace), device] + ([fault] if fault else [])
    res = subprocess.run(args, capture_output=True, text=True, env=env, timeout=600)
    if not check:
        return res
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return strip_copy(tmp_path_factory.mktemp("strip"))


def test_sound_run_is_correct(tiny):
    out = rehearse(tiny, trace=1)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["device"]["count"] == 4 and out["attempted"] >= 1
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_end_to_end_metrics(tiny):
    out = rehearse(tiny)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_mpix_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "strip_lost",
                                   "halo_cut"])
def test_broken_port_is_not_correct(tiny, fault):
    out = rehearse(tiny, fault=fault)
    assert not out["correct"], out["checks"]


def test_a_failing_rank_ends_the_run(tiny):
    """Rank 2 raises in set-up while the others wait in a collective: rank 0
    ends the run nonzero at once, with no result line."""
    from splatbench import ranks

    t0 = time.monotonic()
    res = rehearse(tiny, fault="raise", check=False)
    assert res.returncode != 0
    assert time.monotonic() - t0 < ranks.RUN_TIMEOUT_S
    assert "planted to fail" in res.stderr
    assert not res.stdout.strip()


@pytest.mark.card
def test_four_ranks_share_one_card(card, tiny):
    out = rehearse(tiny, device="cuda:0", trace=1)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 4
    assert {"collective_ms.train", "mesh_skew.train"} - set(out["metrics"]) == {
        "collective_ms.train"}  # gloo runs no NCCL kernel
