"""The port's Session facade (``tpusplat_torch.session``) on the CPU: the five
cases of tests/test_session.py (lifecycle, the self-driving loop, motion in
the camera frame, the rotation rate, a mid-session resize), and the port
against the JAX ``Session`` on the same scene and the same input script:
the pose (atol 1e-12) and the frames (atol 3e-5 rtol 1e-4), also after a
resize."""

import dataclasses

import numpy as np
import pytest
import torch

from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.session import Session as JaxSession, SessionConfig as JaxSessionConfig
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.io.ply import save_ply
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.session import Session, SessionConfig

torch.set_num_threads(2)


def _session(tmp_path, **render_kw):
    params = random_scene(300, seed=1, sh_degree=0, device="cpu")
    path = tmp_path / "s.ply"
    save_ply(path, params)
    cfg = SessionConfig(
        scene=str(path), width=64, height=48,
        render=RenderConfig(sh_degree=0, max_per_tile=256, tile_chunk=4, **render_kw),
    )
    return Session(cfg, device="cpu")


def test_initialize_draw_stop(tmp_path):
    s = _session(tmp_path)
    s.initialize()
    s.position = np.array([0.0, 0.0, 6.0])
    img, aux = s.draw()  # the identity rotation looks down -z, at the scene
    assert img.shape == (48, 64, 3)
    assert float(img.max()) > 0.0
    # Turned around (tests/test_session.py's comment says this faces the
    # scene; in both packages it faces away and the frame is black).
    s.log_translation(np.pi / 0.005, 0.0)
    img, aux = s.draw()
    assert img.shape == (48, 64, 3)
    assert bool(torch.isfinite(img).all())
    assert float(img.max()) == 0.0 and int(aux["num_instances"]) == 0
    s.stop()


def test_start_loop_runs_frames(tmp_path):
    s = _session(tmp_path)
    seen = []
    s.position = np.array([0.0, 0.0, 6.0])
    s.start(on_frame=lambda img, aux: seen.append(1) and None, max_frames=3)
    assert len(seen) == 3


def test_movement_in_camera_frame(tmp_path):
    s = _session(tmp_path)
    s.initialize()
    # Identity rotation: forward is -z, step 0.3 (src/Renderer.cpp:81).
    s.log_movement(0, 0, -1)
    np.testing.assert_allclose(s.position, [0, 0, -0.3], atol=1e-12)
    # Yaw 90 degrees: camera forward maps toward -x.
    s.position[:] = 0
    s.log_translation(-(np.pi / 2) / 0.005, 0.0)
    s.log_movement(0, 0, -1)
    np.testing.assert_allclose(s.position, [-0.3, 0, 0], atol=1e-6)


def test_rotation_rate_matches_reference(tmp_path):
    s = _session(tmp_path)
    s.log_translation(1.0, 0.0)  # one pixel -> 0.005 rad about (0,-1,0)
    ang = 2 * np.arccos(np.clip(s.rotation[0], -1, 1))
    np.testing.assert_allclose(ang, 0.005, rtol=1e-6)
    assert s.rotation[2] < 0  # axis (0,-1,0)


def test_resize_mid_session(tmp_path):
    """A mid-session resolution change (the swapchain recreation,
    src/Renderer.cpp:102-117): the next draw is the frame of a session made
    at the new size, and going back gives the first frame again."""
    s = _session(tmp_path)
    s.initialize()
    s.position = np.array([0.0, 0.0, 6.0])  # facing the scene, so the frames hold it
    img0, _ = s.draw()
    assert img0.shape == (48, 64, 3) and float(img0.max()) > 0.0

    s.resize(96, 80)
    img1, _ = s.draw()
    assert img1.shape == (80, 96, 3)
    assert bool(torch.isfinite(img1).all())

    fresh = _session(tmp_path)
    fresh.initialize()
    fresh.config = dataclasses.replace(fresh.config, width=96, height=80)
    fresh.position = s.position.copy()
    fresh.rotation = s.rotation.copy()
    img2, _ = fresh.draw()
    np.testing.assert_allclose(img1.numpy(), img2.numpy(), atol=1e-6)

    s.resize(64, 48)
    img3, _ = s.draw()
    np.testing.assert_allclose(img3.numpy(), img0.numpy(), atol=1e-6)


def test_session_rejects_params_on_another_device():
    params = random_scene(10, seed=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Session(SessionConfig(), params=params)
    else:
        with pytest.raises(ValueError, match="params lie on"):
            Session(SessionConfig(), params=params)


SCRIPT = [("translate", (12.0, -5.0)), ("move", (0, 0, -1)), ("move", (1, 0, 0)),
          ("translate", (-25.0, 0.0)), ("translate", (0.0, -25.0)), ("move", (0, 1, 1)),
          ("translate", (3.0, 7.0)), ("move", (-1, 0, -1))]


def _drive(s, script):
    for kind, args in script:
        (s.log_translation if kind == "translate" else s.log_movement)(*args)


def test_session_matches_jax():
    """The same input script on both packages' sessions: the pose, and the
    frames before and after a resize."""
    params = jax_random_scene(300, seed=2, sh_degree=1, scale_range=(0.05, 0.3))
    cfg_j = JaxConfig(sh_degree=1, capacity_mult=32, max_per_tile=512, tile_chunk=4,
                      gauss_chunk=16)
    sj = JaxSession(JaxSessionConfig(width=64, height=48, render=cfg_j), params=params)
    p = to_numpy(params)
    tp = convert.params_from_numpy(p.means, p.log_scales, p.quats, p.opacities, p.sh, p.alive,
                                   device="cpu")
    st = Session(SessionConfig(width=64, height=48,
                               render=convert.config_from_fields(dataclasses.asdict(cfg_j))),
                 params=tp, device="cpu")
    for s in (sj, st):
        s.initialize()
        s.position = np.array([0.0, 0.0, 6.0])
    for step in range(len(SCRIPT) + 1):
        np.testing.assert_allclose(st.position, sj.position, atol=1e-12, rtol=0)
        np.testing.assert_allclose(st.rotation, sj.rotation, atol=1e-12, rtol=0)
        if step < len(SCRIPT):
            _drive(sj, SCRIPT[step:step + 1])
            _drive(st, SCRIPT[step:step + 1])
    for size in ((64, 48), (80, 64)):
        sj.resize(*size)
        st.resize(*size)
        img_j, aux_j = sj.draw()
        img_t, aux_t = st.draw()
        assert img_t.shape == (size[1], size[0], 3)
        assert float(img_t.max()) > 0.05  # the scene is in view
        assert int(aux_t["num_instances"]) == int(aux_j["num_instances"])
        np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=3e-5, rtol=1e-4)
