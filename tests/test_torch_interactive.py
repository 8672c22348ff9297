"""The port's interactive loop (``tpusplat_torch.interactive``) on the CPU,
driven by scripted keys: the six cases of tests/test_interactive.py, the
ANSI frame against the JAX ``ansi_frame`` on the same image, the fps EMA
with ``profile_every=1``, and the viewer's ``--interactive`` and its
refusal of ``--mesh`` with it."""

import io

import numpy as np
import pytest
import torch

from tpusplat.interactive import ansi_frame as jax_ansi_frame
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.interactive import ansi_frame, run_interactive
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.session import Session, SessionConfig

torch.set_num_threads(2)


def _session(w=64, h=48):
    cfg = SessionConfig(
        width=w, height=h,
        render=RenderConfig(sh_degree=1, capacity_mult=32, max_per_tile=512,
                            tile_chunk=4, gauss_chunk=16),
    )
    s = Session(cfg, params=random_scene(300, seed=2, sh_degree=1, scale_range=(0.05, 0.3),
                                         device="cpu"), device="cpu")
    s.position = np.array([0.0, 0.0, 6.0])
    return s


def test_scripted_session_moves_and_renders():
    s = _session()
    out = io.StringIO()
    # forward x2, strafe right, look left, idle tick, quit.
    stats = run_interactive(s, keys=["w", "w", "d", "left", None, "q"], out=out, cols=32)
    assert stats["frames"] == 4  # one per input; the idle tick re-renders nothing
    # Two forward steps (-z) then one right (+x) from the identity rotation,
    # then a rotation (no translation).
    assert abs(stats["position"][2] - (6.0 - 0.6)) < 1e-6
    assert abs(stats["position"][0] - 0.3) < 1e-6
    text = out.getvalue()
    assert "instances" in text and "fps" in text
    assert "\x1b[38;2;" in text  # ANSI truecolor frame emitted


def test_idle_ticks_do_not_rerender():
    s = _session()
    stats = run_interactive(s, keys=[None, None, None, "q"], out=io.StringIO(), cols=16)
    assert stats["frames"] == 1  # initial frame only; idle ticks are free


def test_max_frames_stops_loop():
    s = _session()
    stats = run_interactive(s, keys=iter(["w"] * 100), out=io.StringIO(), cols=16,
                            max_frames=3)
    assert stats["frames"] == 3


def test_rotation_changes_view():
    s = _session()
    run_interactive(s, keys=["right", "q"], out=io.StringIO(), cols=16, show_image=False)
    # 25 px * 0.005 rad = 0.125 rad yaw; quaternion no longer identity.
    assert abs(s.rotation[0] - 1.0) > 1e-3


def test_ansi_frame_shape():
    img = np.linspace(0, 1, 32 * 16 * 3).reshape(16, 32, 3)
    text = ansi_frame(img, cols=16)
    lines = text.split("\n")
    assert all(line.endswith("\x1b[0m") for line in lines)
    assert len(lines) >= 2


def test_stage_metrics_overlay_and_draw_profiled():
    """draw_profiled returns the three stage times, and the overlay shows
    them on sampled frames (GUIManager's live stage rows,
    src/GUIManager.cpp:45-100)."""
    s = _session()
    s.initialize()
    img, aux, stage_ms = s.draw_profiled()
    assert set(stage_ms) == {"preprocess", "bin+sort", "raster"}
    assert all(v >= 0.0 for v in stage_ms.values())
    assert bool(torch.isfinite(img).all())
    assert "num_instances" in aux

    s2 = _session()
    out = io.StringIO()
    run_interactive(s2, keys=["w", "w", "w", "q"], out=out, cols=32, profile_every=2)
    text = out.getvalue()
    assert "stages" in text and "raster" in text


def test_ansi_frame_matches_jax():
    """The same string as the JAX ``ansi_frame`` for the same image, given
    as a tensor (sampled on its device) and as an array; odd sizes and cols
    wider than the image included."""
    rng = np.random.default_rng(3)
    for h, w, cols in ((48, 64, 32), (37, 53, 96), (1080 // 20, 1920 // 20, 96), (9, 8, 4)):
        img = rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32)
        want = jax_ansi_frame(img, cols)
        assert ansi_frame(torch.from_numpy(img), cols) == want
        assert ansi_frame(img, cols) == want


class _Clock:
    """``time.time`` stand-in for the interactive module: each frame takes
    a longer, known time, so the EMA's every update shows."""

    def __init__(self):
        self.t, self.calls = 0.0, 0

    def time(self):
        self.calls += 1
        self.t += 0.001 * self.calls
        return self.t


def test_ema_moves_with_profile_every_1(monkeypatch):
    """Every frame feeds the fps EMA, profiled ones too. With
    ``profile_every=1`` every frame after the first is profiled, and the
    JAX loop skips those, so its EMA stays at the first frame's time
    (ADVICE.md:5, ROADMAP Queue 3). This asserts the port's fix, not the
    reference's behaviour."""
    from tpusplat_torch import interactive

    clock = _Clock()
    monkeypatch.setattr(interactive.time, "time", clock.time)
    s = _session()
    out = io.StringIO()
    stats = run_interactive(s, keys=["w", "w", "w", "w", "q"], out=out, cols=16,
                            profile_every=1, show_image=False)
    frame_ms = [float(line.split()[2]) for line in out.getvalue().splitlines()
                if line.startswith("frame ")]
    assert len(frame_ms) == 4 and "(live)" in out.getvalue()
    ema = frame_ms[0]
    for ms in frame_ms[1:]:
        ema = 0.8 * ema + 0.2 * ms
    assert abs(stats["ema_ms"] - ema) < 0.2
    assert stats["ema_ms"] > frame_ms[0] + 1.0  # the later, slower frames moved it


def test_viewer_interactive(monkeypatch, capsys):
    """``viewer --interactive`` drives the session from the keys (here a
    script in place of the tty) at ``--camera`` with ``--cols``, and prints
    one JSON line of stats; the ANSI frame goes to stderr."""
    import json

    from tpusplat_torch import interactive, viewer

    monkeypatch.setattr(interactive, "_tty_keys", lambda stop: iter(["w", "left", "q"]))
    viewer.main(["test", "-i", "--cols", "24", "-w", "64", "--height", "48", "--device", "cpu",
                 "--camera", "0", "0", "6", "--sh-degree", "1"])
    err = capsys.readouterr().err
    stats = json.loads(err.strip().splitlines()[-1])
    assert stats["frames"] == 2 and stats["ema_ms"] > 0
    frame = [ln for ln in err.splitlines() if "\x1b[38;2;" in ln]
    assert frame and all(ln.count("▀") == 24 for ln in frame)
    assert "pos (+0.00 +0.00 +5.70)" in err  # one step of 0.3 down -z from the camera


def test_viewer_refuses_mesh_with_interactive(capsys):
    from tpusplat_torch import viewer

    with pytest.raises(SystemExit) as exc:
        viewer.main(["test", "--interactive", "--mesh", "1x2", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--mesh is not supported with --interactive" in capsys.readouterr().err
