"""The ``train_grow`` kind rehearsed through the harness on the CPU at a
tiny size (the port's plain path): its check passing on the sound port and
failing on each fault planted in the port's round or statistics; its
round counters and stamps in the run's notes; and the densify work model
against hand counts."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

HERE = os.path.join(ROOT, "splatbench")
TINY = dict(name="tinygrow", gaussians=2000, alive_at_start=1000, width=64, height=48,
            views=6)
# set-up ends on the step a round is due at, so the window's first step follows a round
MIX = dict(densify_every=4, checked_round_at=4, window_from_step=8, traced_steps=2,
           loss_reps=2)
FAULTS = ("unchanged", "clone_only", "moments_kept", "noise_zero", "no_stats")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark holding one cell, tiny-grow: garden-grow's
    configuration and train-grow's mix cut to a tiny size and a round every
    4 steps, with the limits of garden-train-grow."""
    root = tmp_path_factory.mktemp("grow")
    dst = root / "splatbench"
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    conf = json.load(open(dst / "configs" / "garden-grow.json"))
    conf.update(TINY)
    json.dump(conf, open(dst / "configs" / "tinygrow.json", "w"))
    mix = json.load(open(dst / "traffic" / "train-grow.json"))
    mix.update(MIX)
    json.dump(mix, open(dst / "traffic" / "tinygrow.json", "w"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"] = [dict(name="tiny-grow", config="tinygrow", traffic="tinygrow",
                               chips=1, why="a test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-grow"] if "garden-train-grow" in m["workloads"] else []
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    shutil.copy(dst / "limits" / "garden-train-grow.json", dst / "limits" / "tiny-grow.json")
    return root


def rehearse(root, trace=0, fault=None, seed=2**31 + 7):
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}", OMP_NUM_THREADS="1")
    args = [sys.executable, os.path.join(HERE, "tests", "rehearse_grow.py"), str(root),
            "tiny-grow", str(seed), "0.5", str(trace)] + ([fault] if fault else [])
    res = subprocess.run(args, capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), res.stderr


def _notes(stderr):
    line = next(ln for ln in stderr.splitlines() if ln.startswith("workload="))
    return line


def test_sound_run_is_correct_and_rounds_both_clone_and_split(tiny):
    out, err = rehearse(tiny)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_mpix_s", "setup_s"}
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap", "stats_gap",
                                  "decision_mismatch", "kept_gap", "split_noise_mean",
                                  "split_noise_std_gap", "split_noise_corr"}
    notes = _notes(err)
    assert "round_counts=[{'candidates'" in notes, notes
    assert int(re.search(r"rounds_in_window=(\d+)", notes)[1]) >= 1, notes
    checked = re.search(r"checked_round=\{'candidates': \d+, 'granted': \d+, "
                        r"'cloned': (\d+), 'split': (\d+)", notes)
    assert int(checked[1]) > 0 and int(checked[2]) > 0, notes


def test_traced_run_reads_the_host_spans(tiny):
    """On the CPU the stamps take the host clock: the densify readers stay
    silent with the other stage readers; the loss span reports."""
    out, _ = rehearse(tiny, trace=1)
    assert out["correct"]
    assert set(out["metrics"]) == {"loss_ms.train"}


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_port_is_not_correct(tiny, fault):
    out, _ = rehearse(tiny, fault=fault)
    assert not out["correct"], out["checks"]


def test_round_bytes_by_hand():
    from splatbench import workmodel_densify as wd

    counts = dict(granted=10, split=4, pruned=3)
    row, moments = 59 * 4, 2 * 59 * 4
    want = (100 * (8 + 12 + 4 + 1 + 12) + 10 * (2 * row + 1 + moments) + 4 * (24 + moments)
            + 3 * (1 + moments))
    assert wd.round_bytes(100, counts) == want
    assert wd.round_bound_s(100, counts) == pytest.approx(want / 3.35e12)


def test_densify_readers_by_hand():
    """The round's ms from stamps laid out by hand on the device clock, and
    its roofline from its counters: 100% where the round takes exactly its
    least time; nothing without rounds."""
    import importlib.util
    import types

    from splatbench import workmodel_densify as wd
    import tpusplat_torch.trace as ptrace

    def reader(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, "metrics", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    counts = [dict(granted=1000, split=400, pruned=10), dict(granted=500, split=100, pruned=0)]
    slots = 10_000_000
    least = [wd.round_bound_s(slots, c) for c in counts]
    t, entries = 1_000_000, []
    for i, s in enumerate(least):  # a step, then a round taking exactly its least time
        entries += [(len(entries), t, "preprocess", 2), (len(entries) + 1, t + 500, "end", 2)]
        t += 1000
        ns = round(s * 1e9)
        entries += [(len(entries), t, "densify", 3), (len(entries) + 1, t + ns, "end", 3)]
        t += ns + 1000
    stamps = ptrace.Stamps("device", 0, entries)
    run = types.SimpleNamespace(device="cuda", trace=object(), conf=dict(gaussians=slots),
                                rounds=dict(tag=3, count=2, counts=counts))
    real = ptrace.read
    ptrace.read = lambda *a, **k: stamps
    try:
        ms = reader("densify_ms.train")(run)
        roof = reader("densify_roofline.train")(run)
        run.rounds = dict(run.rounds, count=0)
        silent = reader("densify_ms.train")(run), reader("densify_roofline.train")(run)
    finally:
        ptrace.read = real
    assert ms == pytest.approx(sum(least) / 2 * 1e3, rel=1e-5)  # the stamps' whole ns
    assert roof == pytest.approx(100.0, rel=1e-5)
    assert silent == (None, None)
