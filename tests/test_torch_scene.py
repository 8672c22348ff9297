"""The port's scene inputs against the JAX package: synthetic scenes,
camera matrices (mirroring tests/test_camera.py) and PLY files."""

import dataclasses

import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.camera import make_camera as jax_make_camera
from tpusplat.io.ply import load_ply as jax_load_ply
from tpusplat.io.ply import save_ply as jax_save_ply
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.types import to_numpy
from tpusplat_torch.camera import look_at_camera, make_camera, perspective, quat_to_rotmat
from tpusplat_torch.io.ply import load_ply, save_ply
from tpusplat_torch.io.synthetic import random_scene

torch.set_num_threads(2)

PARAM_FIELDS = ("means", "log_scales", "quats", "opacities", "sh", "alive")


@pytest.mark.parametrize("n,sh_degree,extent,srange", [
    (300, 0, 3.0, (0.01, 0.15)),
    (1000, 3, 4.0, (0.002, 0.02)),
])
def test_random_scene_identical(n, sh_degree, extent, srange):
    kw = dict(seed=n, sh_degree=sh_degree, extent=extent, scale_range=srange)
    ref = to_numpy(jax_random_scene(n, **kw))
    got = random_scene(n, device="cpu", **kw)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(ref, f), err_msg=f)


@pytest.mark.parametrize("pos,quat,w,h,fov", [
    ([0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], 640, 480, 90.0),
    ([1.0, 2.0, 3.0], [np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0], 640, 480, 45.0),
    ([-0.5, 0.3, 4.0], [0.9, 0.1, -0.2, 0.3], 128, 96, 60.0),
])
def test_make_camera_matches_jax(pos, quat, w, h, fov):
    ref = to_numpy(jax_make_camera(pos, quat, w, h, fov_deg=fov))
    got = make_camera(pos, quat, w, h, fov_deg=fov, device="cpu")
    for f in ("view", "proj", "cam_pos", "tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f), atol=1e-6,
                                   err_msg=f)
    assert (got.width, got.height) == (ref.width, ref.height)


@pytest.mark.parametrize("eye,target,w,h,fov", [
    ([0.0, 0.5, 9.0], [0.0, 0.0, 0.0], 1920, 1080, 60.0),
    ([0.3, 0.2, 6.0], [0.0, 0.0, 0.0], 64, 48, 60.0),
    ([4.0, -1.0, 2.0], [0.5, 0.5, -0.5], 96, 64, 45.0),
])
def test_look_at_camera_matches_jax(eye, target, w, h, fov):
    ref = to_numpy(jax_look_at(eye, target, w, h, fov_deg=fov))
    got = look_at_camera(eye, target, w, h, fov_deg=fov, device="cpu")
    for f in ("view", "proj", "cam_pos", "tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f), atol=1e-6,
                                   err_msg=f)


def test_identity_camera_matrices():
    cam = make_camera([0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], 640, 480, fov_deg=90.0,
                      device="cpu")
    np.testing.assert_allclose(cam.view.numpy(), np.diag([1.0, -1.0, -1.0, 1.0]), atol=1e-6)
    assert np.isclose(float(cam.tan_fovx), 1.0)
    assert np.isclose(float(cam.tan_fovy), 480.0 / 640.0)


def test_projection_point_through_pipeline():
    cam = make_camera([0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], 800, 600, fov_deg=60.0,
                      device="cpu")
    p = np.array([0.0, 0.0, -5.0, 1.0])
    assert np.isclose((cam.view.double().numpy() @ p)[2], 5.0, atol=1e-6)
    p_hom = cam.proj.double().numpy() @ p
    assert np.allclose(p_hom[:2] / p_hom[3], 0.0, atol=1e-6)
    assert np.isclose(p_hom[3], 5.0, atol=1e-6)


def test_perspective_and_rotation_match_glm():
    p = perspective(0.5, 4.0 / 3.0, 0.2, 1000.0)
    assert np.isclose(p[0, 0], 1.0 / (4.0 / 3.0 * 0.5))
    assert np.isclose(p[1, 1], 2.0)
    assert np.isclose(p[2, 3], -(2 * 1000.0 * 0.2) / (1000.0 - 0.2))
    assert p[3, 2] == -1.0
    q = np.random.default_rng(0).normal(size=4)
    r = quat_to_rotmat(q / np.linalg.norm(q))
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)
    assert np.isclose(np.linalg.det(r), 1.0)


def test_ply_roundtrip_between_packages(tmp_path):
    params = random_scene(257, seed=4, sh_degree=3, device="cpu")
    alive = params.alive.clone()
    alive[::5] = False
    params = dataclasses.replace(params, alive=alive)
    path = tmp_path / "port.ply"
    save_ply(path, params)
    ref = to_numpy(jax_load_ply(path, use_native=False))
    keep = alive.numpy()
    for f in PARAM_FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(ref, f), getattr(params, f).numpy()[keep],
                                      err_msg=f)

    # And the other direction: the JAX writer, the port's reader.
    path2 = tmp_path / "jax.ply"
    jax_save_ply(path2, jax_random_scene(100, seed=2, sh_degree=2))
    got = load_ply(path2, device="cpu")
    ref2 = to_numpy(jax_load_ply(path2, use_native=False))
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(ref2, f), err_msg=f)
