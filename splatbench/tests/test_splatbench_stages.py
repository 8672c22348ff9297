"""``splatbench/stages.py``: the port's stage stamps and host spans reduced
to the per-layer numbers, on a hand-made ring and span list and on a CPU
rehearsal of each kind of cell (where the stamps take the host clock, so the
readers stay silent while the reduction runs)."""

import json
import os
import sys
import types

import pytest
import torch

from conftest import ROOT
from test_splatbench_cells import TINY, TRAIN, VIEW

from splatbench import drive, stages
from tpusplat_torch import trace

HERE = os.path.join(ROOT, "splatbench")
MS = 1_000_000  # ns
FRAME = ("preprocess", "binning", "blend", "end")


def _span(index, name, start, end, parent=-1, unit=0):
    return trace.Span(index, name, start * MS, end * MS, parent, unit)


def _frames(starts, tag=3):
    """Stamps of frames starting at ``starts`` (ms): stages of 1, 2 and 3 ms."""
    entries, seq = [], 0
    for s in starts:
        for name, at in zip(FRAME, (0, 1, 3, 6)):
            entries.append((seq, (s + at) * MS, name, tag))
            seq += 1
    return trace.Stamps("device", 0, entries)


def test_reduce_by_hand():
    """Four frames 10 ms apart, of which the last three are the tail: stages
    1, 2 and 3 ms, gaps 4 ms, of which the host spent 1.5 ms inside program
    spans (mapped by the offset) in the first and 1 ms in the second."""
    stamps = _frames([0, 10, 20, 30])
    offset = 100 * MS  # the device clock leads the host's by 100 ms
    spans = [
        _span(0, "draw", -100 + 15.0, -100 + 22.0),  # gap 16-20: 15-20 inside draw
        _span(1, "copy_in", -100 + 17.0, -100 + 17.5, parent=0),
        _span(2, "replay", -100 + 19.5, -100 + 19.8, parent=0),
        _span(3, "read_overflow", -100 + 26.0, -100 + 27.0, unit=1),  # gap 26-30
        _span(4, "draw", -100 + 5.0, -100 + 12.0),  # before the tail: not counted
    ]
    out = stages.reduce(stamps.units(), spans, offset, tail=3)
    assert out["units"] == 3
    assert out["stage_ms"] == pytest.approx(dict(preprocess=1.0, binning=2.0, blend=3.0))
    assert out["gap_ms"] == pytest.approx(4.0)
    assert out["unit_ms"] == pytest.approx(10.0)
    assert out["unit_ms"] == pytest.approx(sum(out["stage_ms"].values()) + out["gap_ms"])
    # gap 1 [16, 20]: draw 16-17 and 17.5-19.5 and 19.8-20, copy_in 0.5, replay 0.3
    assert out["gap_program_ms"] == pytest.approx((4.0 + 1.0) / 2)
    assert out["gap_split_ms"] == pytest.approx(
        dict(draw=3.2 / 2, copy_in=0.5 / 2, replay=0.3 / 2, read_overflow=1.0 / 2))
    assert out["lead_min_ms"] == pytest.approx(0.5)  # replay at 19.5, frame at 20
    # The whole ring instead of its tail: the first gap, [6, 10], inside the
    # earlier draw, joins.
    assert stages.reduce(stamps.units(), spans, offset, tail=4)["gap_program_ms"] == \
        pytest.approx((4.0 + 4.0 + 1.0) / 3)
    assert stages.reduce(stamps.units(), spans, offset, tail=1) is None


def test_innermost_names_each_moment():
    spans = [_span(0, "a", 0, 10), _span(1, "b", 2, 4, parent=0),
             _span(2, "c", 3, 3.5, parent=1), _span(3, "d", 6, 10, parent=0)]
    got = [(s / MS, e / MS, n) for s, e, n in stages.innermost(spans, 0)]
    assert got == [(0, 2, "a"), (2, 3, "b"), (3, 3.5, "c"), (3.5, 4, "b"), (4, 6, "a"),
                   (6, 10, "d")]


def test_traced_check_reads_the_profilers_stamp_records():
    stamps = _frames([0, 10])
    device = [(f"tpusplat_stamp_{n}", t / 1e9 + 0.5, t / 1e9 + 0.501)
              for _, t, n, _ in stamps.entries] + [("forward_kernel", 0.5, 0.6)]
    out = stages.traced_check(stamps.units(), device)
    assert out["cupti_units"] == 2 and out["units"] == 2
    assert out["cupti_ms"] == pytest.approx(out["ring_ms"])
    assert out["max_rel_diff"] == pytest.approx(0.0, abs=1e-9)


def _run(tmp_path, kind, traced=True):
    conf = json.load(open(os.path.join(HERE, "configs", "garden.json")))
    conf.update(TINY)
    mix = json.load(open(os.path.join(HERE, "traffic", f"{kind}.json")))
    mix.update(dict(train=TRAIN, view=VIEW)[kind], traced_steps=1, traced_frames=1)
    run = drive.Run(conf=conf, traffic=mix, seed=2**31 + 11, seconds=1.5, traced=traced,
                    device=torch.device("cpu"))
    m = drive.load_kind(kind)(run)
    m.setup()
    m.window()
    return run


@pytest.mark.parametrize("kind", ["train", "view"])
def test_cpu_rehearsal_stages_and_gap_make_the_unit(tmp_path, kind, monkeypatch):
    """On the CPU the stamps take the host clock: each unit's stages and gap
    add up to its period, the mean period is the window's untraced unit time,
    only the untraced tail is taken, and the readers stay silent."""
    monkeypatch.setattr(trace, "_host", trace._HostRings())
    run = _run(tmp_path, kind)
    s = stages.summary(run)
    assert s is not None and s["clock"] == "host" and run.notes["stages"] is s
    done = run.attempted if kind == "train" else run.units
    assert s["units"] == done - run.trace.units >= 2
    order = ["preprocess", "binning", "blend"] + (
        ["loss", "blend_bwd", "preprocess_bwd", "adam", "writeback"] if kind == "train" else [])
    assert list(s["stage_ms"]) == order
    assert sum(s["stage_ms"].values()) + s["gap_ms"] == pytest.approx(s["unit_ms"], rel=0.05)
    assert s["unit_ms"] == pytest.approx(run.trace.unit_s_untraced * 1e3, rel=0.25)
    assert 0 < s["gap_program_ms"] <= s["gap_ms"] + 1e-9
    assert s["lead_min_ms"] >= 0  # a replay's first stamp follows its launch
    for name in os.listdir(os.path.join(HERE, "metrics")):
        if name.split(".")[0].endswith("ms") and "loss_ms" not in name:
            from splatbench.run import reader

            assert reader(name[:-3])(run) is None, name


def test_readers_are_silent_without_the_tracer(monkeypatch):
    """A port without ``tpusplat_torch.trace`` (the parent of the tracer)
    gives nothing, and no reader raises."""
    monkeypatch.setitem(sys.modules, "tpusplat_torch.trace", None)
    run = types.SimpleNamespace(trace=types.SimpleNamespace(units=3), notes={}, units=9,
                                attempted=9, traffic=dict(kind="view"))
    assert stages.summary(run) is None
    assert stages.value(run, "gap_ms") is None
