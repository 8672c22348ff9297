"""The port's tracer (tpusplat_torch/trace.py) on the CPU, where the stamps
take the host clock through the same calls: the stamp orders of a compiled
training step and of a compiled frame, nothing changed by tracing, the
spans' nesting and the rings' bounds, the overlay's stage times from the
session's own graph, the device ring's layout and the clocks' anchor."""

import numpy as np
import pytest
import torch

from tpusplat_torch import trace
from tpusplat_torch.camera import look_at_camera
from tpusplat_torch.compiled import flatten
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.render import compile_render, render_auto, render_profiled
from tpusplat_torch.session import Session, SessionConfig
from tpusplat_torch.train import step as tstep

FRAME = ["preprocess", "binning", "blend", "end"]
STEP = ["preprocess", "binning", "blend", "loss", "blend_bwd", "preprocess_bwd", "adam",
        "writeback", "end"]


@pytest.fixture(autouse=True)
def rings(monkeypatch):
    """Fresh host rings, one thread (the bit-for-bit comparisons)."""
    h = trace._HostRings()
    monkeypatch.setattr(trace, "_host", h)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield h
    torch.set_num_threads(threads)


def _inputs():
    params = random_scene(400, seed=3, sh_degree=1, device="cpu")
    cam = look_at_camera([0.0, 0.5, 6.0], [0.0, 0.0, 0.0], 48, 32, fov_deg=60.0, device="cpu")
    cfg = RenderConfig(sh_degree=1, max_per_tile=256, tile_chunk=4)
    g = torch.Generator().manual_seed(5)
    target = torch.rand((32, 48, 3), generator=g)
    return params, cam, cfg, target


def _names(unit):
    return [name for name, _ in unit.marks]


def test_stamp_orders_of_the_compiled_step_and_frame():
    params, cam, cfg, target = _inputs()
    opt = tstep.make_optimizer(scene_extent=4.0)
    step, render = tstep.compile_train_step(), compile_render()
    state = tstep.create_train_state(params)
    for _ in range(3):
        state, _ = step(state, cam, target, cfg, opt)
        with torch.no_grad():
            render(state.params, cam, cfg)
    render_auto(state.params, cam, cfg, compiled=render)
    stamps = trace.read("cpu")
    assert stamps.clock == "host" and stamps.offset_ns == 0
    steps, frames = stamps.units(step.tag), stamps.units(render.tag)
    assert [_names(u) for u in steps] == [STEP] * 3
    assert [_names(u) for u in frames] == [FRAME] * 4
    assert stamps.last_tag() == render.tag and stamps.units()[-1] == frames[-1]
    # A frame between two steps does not split the steps' sequence; a stage
    # runs to the next stamp, and each gap to the next unit's first.
    gaps = trace.gaps(steps)
    assert len(gaps) == 2 and min(gaps) > 0
    for a, b, gap in zip(steps, steps[1:], gaps):
        assert sum(a.stage_ms().values()) + gap == pytest.approx((b.start_ns - a.start_ns) / 1e6)
    assert list(steps[0].stage_ms()) == STEP[:-1]


@pytest.mark.parametrize("what", ["frame", "step"])
def test_tracing_changes_no_bit(what, monkeypatch):
    """Images, losses, gradients and the new state are equal bit for bit with
    tracing on and off; off, nothing is stamped or recorded."""
    params, cam, cfg, target = _inputs()
    opt = tstep.make_optimizer(scene_extent=4.0)
    outs = []
    for on in (True, False):
        monkeypatch.setattr(trace, "enabled", on)
        trace._host.stamps.clear()
        trace._host.spans.clear()
        if what == "frame":
            with torch.no_grad():
                img, aux, _ = render_auto(params, cam, cfg, compiled=compile_render())
            out = [img, aux["transmittance"], aux["radius"]]
        else:
            state = tstep.create_train_state(random_scene(400, seed=3, sh_degree=1,
                                                          device="cpu"))
            loss, _, leaves = tstep.step_forward(state, cam, target, cfg)
            grads = tstep.step_backward(loss, leaves)
            step = tstep.compile_train_step()
            state, metrics = step(state, cam, target, cfg, opt)
            state, metrics = step(state, cam, target, cfg, opt)
            out = [loss, metrics["loss"], *grads.values()]
            flatten(state, out)
        outs.append(out)
        assert bool(trace._host.stamps) == on and bool(trace._host.spans) == on
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_spans_nest_with_their_parents():
    params, _, cfg, _ = _inputs()
    s = Session(SessionConfig(width=48, height=32, render=cfg), params=params, device="cpu")
    s.initialize()
    s.position = np.array([0.0, 0.0, 6.0])
    s.draw()
    s.draw()
    spans = trace.spans()
    by_index = {sp.index: sp for sp in spans}

    def path(sp):
        out = [sp.name]
        while sp.parent >= 0:
            sp = by_index[sp.parent]
            out.append(sp.name)
        return "/".join(reversed(out))

    first = sorted(path(sp) for sp in spans if sp.unit == 0)
    assert first == sorted([
        "draw", "draw/camera", "draw/render_auto", "draw/render_auto/read_overflow",
        "draw/render_auto/compiled:render_stages",
        "draw/render_auto/compiled:render_stages/key",
        "draw/render_auto/compiled:render_stages/capture",
        "draw/render_auto/compiled:render_stages/copy_out"])
    second = sorted(path(sp) for sp in spans if sp.unit == 1)
    assert "draw/render_auto/compiled:render_stages/copy_in" in second
    assert "draw/render_auto/compiled:render_stages/replay" in second
    assert {sp.unit for sp in spans} == {0, 1}
    for sp in spans:
        assert sp.end_ns >= sp.start_ns
        if sp.parent >= 0:
            parent = by_index[sp.parent]
            assert parent.start_ns <= sp.start_ns and sp.end_ns <= parent.end_ns
    assert not trace._host.open


def test_rings_drop_their_oldest_entries(monkeypatch):
    monkeypatch.setattr(trace, "_host", trace._HostRings(stamps=6, spans=4))
    for i in range(6):
        with trace.span(f"s{i}"):
            pass
    assert [sp.name for sp in trace.spans()] == ["s2", "s3", "s4", "s5"]
    assert [sp.unit for sp in trace.spans()] == [2, 3, 4, 5]
    cpu = torch.device("cpu")
    with trace.tagged(7):
        for _ in range(2):
            for name in FRAME:
                trace.stage(name, cpu)
    stamps = trace.read(cpu)
    assert [e[0] for e in stamps.entries] == [2, 3, 4, 5, 6, 7]
    # The oldest unit lost its first stamps: it is left out.
    assert [_names(u) for u in stamps.units(7)] == [FRAME]
    assert [_names(u) for u in trace.read(cpu, last=5).units(7)] == [FRAME]
    assert trace.read(cpu, last=4).units(7) == []


def test_unpack_reads_the_device_ring_in_order():
    """The device ring's layout: [n, 2] of (time, (tag << 8) | stage), the
    slot of stamp k at k mod n."""
    n, head = 4, 6
    ring = np.zeros((n, 2), np.uint64)
    for k in range(head):
        ring[k % n] = (1000 + k, (9 << 8) | (k % len(trace.STAGES)))
    got = trace.unpack(ring, head)
    assert got == [(k, 1000 + k, trace.STAGES[k % len(trace.STAGES)], 9) for k in range(2, 6)]
    assert trace.unpack(ring, head, last=1) == got[-1:]
    assert trace.unpack(ring[[0, 1, 2, 2]], 3) == [
        (0, 1004, trace.STAGES[4], 9), (1, 1005, trace.STAGES[5], 9), (2, 1002, trace.STAGES[2], 9)]


def test_draw_profiled_replays_the_session_graph():
    """The overlay's stage times are the stamps of the session's own graph:
    a draw_profiled between two draws captures nothing."""
    params, _, cfg, _ = _inputs()
    s = Session(SessionConfig(width=48, height=32, render=cfg), params=params, device="cpu")
    s.initialize()
    s.position = np.array([0.0, 0.0, 6.0])
    img0, _ = s.draw()
    img, aux, stage_ms = s.draw_profiled()
    s.draw()
    assert s._render.stats["captures"] == 1 and s._render.stats["replays"] == 3
    assert torch.equal(img, img0) and int(aux["capacity_overflow"]) == 0
    units = trace.read("cpu").units(s._render.tag)
    assert len(units) == 3
    ms = units[1].stage_ms()
    assert stage_ms == {"preprocess": ms["preprocess"], "bin+sort": ms["binning"],
                        "raster": ms["blend"]}
    assert all(v > 0.0 for v in stage_ms.values())


def test_render_profiled_reads_its_own_stamps():
    params, cam, cfg, _ = _inputs()
    img, aux, stage_ms = render_profiled(params, cam, cfg)
    (unit,) = trace.read("cpu").units(trace.PROFILED)
    assert _names(unit) == FRAME
    ms = unit.stage_ms()
    assert list(stage_ms.values()) == [ms["preprocess"], ms["binning"], ms["blend"]]
    assert "visible" in aux and img.shape == (32, 48, 3)


def test_anchor_maps_host_spans_onto_the_device_clock():
    """The least offset of (host before launch, device) pairs: each pair's
    device time trails the true offset by its launch latency."""
    true_offset = 7_000_000_000_123
    latency = [950, 40_000, 812, 3_100, 15_000]
    hosts = [10_000, 250_000, 400_000, 900_000, 1_500_000]
    pairs = [(h, h + true_offset + lat) for h, lat in zip(hosts, latency)]
    offset = trace.least_offset(pairs)
    assert offset == true_offset + min(latency)
    # A host span at 2 ms lands on the device clock a least latency late.
    assert 2_000_000 + offset - (2_000_000 + true_offset) == min(latency)
    assert trace.anchor("cpu") == 0  # the CPU's stamps take the host clock
    # The clocks drift: between two anchors the offset is interpolated,
    # outside them the nearest one's holds.
    stamps = trace.Stamps("device", 500, [], anchors=[(1_000, 100), (11_000, 110)])
    assert [stamps.offset_at(t) for t in (0, 1_000, 6_000, 11_000, 20_000)] == \
        [100, 100, 105, 110, 110]
    assert trace.Stamps("device", 500, []).offset_at(6_000) == 500
