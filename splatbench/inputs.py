"""The benchmark's inputs, made from ``--seed`` by the benchmark itself: the
scene, the cameras of the training views, the orbit poses of the viewer and
the target images. The sizes come from the configuration, the camera paths
(the training ring, the viewer's orbit) from the traffic mix.

Frozen copies of the port's generators (``io/synthetic.random_scene``'s
distribution, ``camera.look_at_camera`` / ``make_camera``'s float64 math,
``chip_smoke.orbit_cameras``' orbit, ``trainer._synthetic_views``' ring), so
that a change to the port cannot move the yardstick. The scene and the
targets are drawn on the device with a seeded ``torch.Generator``, in a few
large calls; the cameras in float64 numpy from a seeded generator. One seed
gives the same inputs on every run.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# random_scene's ranges: opacity uniform in [0.1, 0.95]; SH band 0 uniform
# in [-1, 1.5], the higher bands in [-0.3, 0.3].
OPACITY_RANGE = (0.1, 0.95)
SH_DC_RANGE = (-1.0, 1.5)
SH_REST_RANGE = (-0.3, 0.3)
NEAR, FAR = 0.2, 1000.0
# Target images: seeded noise at 1/TARGET_CELL of the frame, upsampled
# bilinearly, so that SSIM sees structure at several scales.
TARGET_CELL = 16


def make_scene(conf: dict, seed: int, device) -> dict:
    """Raw (pre-activation) Gaussian parameters of a configuration, all
    alive: ``means`` [N, 3] uniform in the cube of half-side ``extent``,
    ``log_scales`` [N, 3] the log of a uniform scale in ``scale_range``,
    ``quats`` [N, 4] normalised normals, ``opacities`` [N] the logit of a
    uniform opacity, ``sh`` [N, 16, 3], ``alive`` [N] bool. float32."""
    n, ext = conf["gaussians"], float(conf["extent"])
    lo, hi = conf["scale_range"]
    k = (conf["sh_degree"] + 1) ** 2
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    u = torch.rand((n, 10), generator=g, device=device)
    quats = torch.randn((n, 4), generator=g, device=device)
    rest = torch.rand((n, 15, 3), generator=g, device=device)
    op = OPACITY_RANGE[0] + u[:, 6] * (OPACITY_RANGE[1] - OPACITY_RANGE[0])
    sh = torch.zeros((n, 16, 3), device=device)
    sh[:, 0] = SH_DC_RANGE[0] + u[:, 7:10] * (SH_DC_RANGE[1] - SH_DC_RANGE[0])
    sh[:, 1:k] = SH_REST_RANGE[0] + rest[:, : k - 1] * (SH_REST_RANGE[1] - SH_REST_RANGE[0])
    return dict(
        means=(u[:, 0:3] * 2.0 - 1.0) * ext,
        log_scales=torch.log(lo + u[:, 3:6] * (hi - lo)),
        quats=quats / torch.linalg.vector_norm(quats, dim=1, keepdim=True),
        opacities=torch.log(op / (1.0 - op)),
        sh=sh,
        alive=torch.ones(n, dtype=torch.bool, device=device),
    )


def make_targets(conf: dict, seed: int, device) -> torch.Tensor:
    """[views, H, W, 3] float32 target images in [0, 1], on the device."""
    v, w, h = conf["views"], conf["width"], conf["height"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 1)
    coarse = torch.rand((v, 3, -(-h // TARGET_CELL) + 1, -(-w // TARGET_CELL) + 1),
                        generator=g, device=device)
    out = torch.empty((v, h, w, 3), device=device)
    for i in range(0, v, 16):  # bounds the upsampling's transient memory
        up = F.interpolate(coarse[i:i + 16], size=(h, w), mode="bilinear",
                           align_corners=False)
        out[i:i + 16] = up.permute(0, 2, 3, 1)
    return out


# -- cameras (float64 numpy, the shader convention of the port's camera.py) --

_FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0])
_FLIP_Y = np.diag([1.0, -1.0, 1.0, 1.0])


def _perspective(tan_fovy, aspect, near, far):
    p = np.zeros((4, 4))
    p[0, 0] = 1.0 / (aspect * tan_fovy)
    p[1, 1] = 1.0 / tan_fovy
    p[2, 2] = -(far + near) / (far - near)
    p[2, 3] = -(2.0 * far * near) / (far - near)
    p[3, 2] = -1.0
    return p


def quat_to_rotmat(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_quat(r) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix."""
    tr = np.trace(r)
    if tr > 0:
        s = 2.0 * math.sqrt(tr + 1.0)
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * math.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k])
        q = [0.0] * 4
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def camera_matrices(rot, pos, width, height, fov_deg) -> dict:
    """The camera of a pose (``rot``: camera-to-world rotation, columns the
    camera's +x, +y and +z = -forward in the world) as the port's
    ``make_camera`` builds it: view and proj in the shader convention,
    ``cam_pos``, ``tan_fovx``, ``tan_fovy``, width and height."""
    pos = np.asarray(pos, np.float64)
    view = np.eye(4)
    view[:3, :3] = rot.T
    view[:3, 3] = rot.T @ (-pos)
    tan_fovx = math.tan(math.radians(fov_deg) / 2.0)
    tan_fovy = tan_fovx * height / width
    proj = _perspective(tan_fovy, width / height, NEAR, FAR) @ view
    return dict(view=_FLIP_YZ @ view, proj=_FLIP_Y @ proj, cam_pos=pos, tan_fovx=tan_fovx,
                tan_fovy=tan_fovy, width=int(width), height=int(height))


def look_at_rot(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    fwd = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(right, fwd), -fwd], axis=1)


def training_views(conf: dict, ring: dict, seed: int) -> list[dict]:
    """The ring of training cameras (the traffic's ``ring``): view i at
    angle 2 pi i / views, radius ``ring["radius"]``, height uniform in
    [-``height_jitter``, ``height_jitter``] (``trainer._synthetic_views``'
    jitter), looking at the origin."""
    rng = np.random.default_rng(int(seed))
    v, r, jit = conf["views"], float(ring["radius"]), float(ring["height_jitter"])
    out = []
    for i in range(v):
        ang = 2 * math.pi * i / v
        eye = np.array([r * math.sin(ang), rng.uniform(-jit, jit), r * math.cos(ang)])
        out.append(camera_matrices(look_at_rot(eye, (0, 0, 0)), eye, conf["width"],
                                   conf["height"], conf["fov"]))
    return out


def orbit_poses(orbit: dict) -> list[tuple[np.ndarray, np.ndarray]]:
    """(position, (w, x, y, z) rotation) of the traffic's ``orbit``:
    ``poses_per_rev`` poses a revolution about the y axis through the
    origin, looking at it, at height ``height``. The distance from the axis
    swings from ``radius[0]`` (angle 0) to ``radius[1]`` (half a turn) and
    back, as a cosine; with both equal it is ``orbit_cameras``' orbit."""
    r0, r1 = (float(r) for r in orbit["radius"])
    n, h = orbit["poses_per_rev"], float(orbit["height"])
    out = []
    for i in range(n):
        ang = 2 * math.pi * i / n
        r = r0 + (r1 - r0) * (1.0 - math.cos(ang)) / 2.0
        eye = np.array([r * math.sin(ang), h, r * math.cos(ang)])
        out.append((eye, rotmat_to_quat(look_at_rot(eye, (0, 0, 0)))))
    return out


def pose_matrices(conf: dict, pose) -> dict:
    """The camera of an orbit pose, as ``Session.camera`` builds it from
    its position and quaternion."""
    pos, quat = pose
    return camera_matrices(quat_to_rotmat(quat), pos, conf["width"], conf["height"],
                           conf["fov"])
