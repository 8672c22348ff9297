"""Camera matrix construction with reference parity (counterpart of
``tpusplat/camera.py``; the same float64 numpy math, so the matrices agree
with the JAX package's before both round to float32).

Reproduces ``Renderer::updateUniforms`` (``src/Renderer.cpp:719-754``):
``view = inverse(translate(pos) * mat4_cast(rot))``, ``proj =
glm::perspective(...) * view`` with the unflipped view, then ``view`` gets
rows 1 and 2 negated and ``proj`` row 1. ``tan_fovx = tan(radians(fov)/2)``
and ``tan_fovy = tan_fovx * h / w``.
"""

from __future__ import annotations

import numpy as np

from tpusplat_torch.types import Camera


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Rotation matrix from a (w, x, y, z) quaternion (``glm::mat4_cast``)."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def perspective(tan_fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """glm::perspective (right-handed, [-1, 1] clip depth — glm's default)."""
    p = np.zeros((4, 4), np.float64)
    p[0, 0] = 1.0 / (aspect * tan_fovy)
    p[1, 1] = 1.0 / tan_fovy
    p[2, 2] = -(far + near) / (far - near)
    p[2, 3] = -(2.0 * far * near) / (far - near)
    p[3, 2] = -1.0
    return p


_FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0])  # negate rows 1,2 (view)
_FLIP_Y = np.diag([1.0, -1.0, 1.0, 1.0])  # negate row 1 (proj)


def _camera(view, cam_pos, tan_fovx, tan_fovy, width, height, near, far, device):
    proj = perspective(tan_fovy, width / height, near, far) @ view
    return Camera.from_matrices(
        view=_FLIP_YZ @ view,
        proj=_FLIP_Y @ proj,
        cam_pos=cam_pos,
        tan_fovx=tan_fovx,
        tan_fovy=tan_fovy,
        width=width,
        height=height,
        device=device,
    )


def make_camera(
    position,
    rotation_quat_wxyz,
    width: int,
    height: int,
    fov_deg: float = 45.0,
    near: float = 0.2,
    far: float = 1000.0,
    device="cuda",
) -> Camera:
    """Build a Camera exactly as the reference viewer does (defaults from
    ``include/3dgs/3dgs.h:13-25``: fov=45, near=0.2, far=1000)."""
    pos = np.asarray(position, np.float64)
    rot = quat_to_rotmat(np.asarray(rotation_quat_wxyz, np.float64))

    # view = inverse(translate(pos) @ rot4) = rot.T @ translate(-pos)
    view = np.eye(4)
    view[:3, :3] = rot.T
    view[:3, 3] = rot.T @ (-pos)

    tan_fovx = np.tan(np.radians(fov_deg) / 2.0)
    tan_fovy = tan_fovx * height / width
    return _camera(view, pos, tan_fovx, tan_fovy, width, height, near, far, device)


def camera_from_world_view(
    view_world_to_cam,
    width: int,
    height: int,
    tan_fovx: float,
    tan_fovy: float,
    near: float = 0.2,
    far: float = 1000.0,
    device="cuda",
) -> Camera:
    """A Camera from any world-to-camera matrix (COLMAP, NeRF-synthetic).

    The matrix maps world points to a camera frame with +x right, +y up and
    -z forward (OpenGL), the frame ``make_camera`` builds before the
    shader-space flips. The projection's aspect is ``tan_fovx / tan_fovy``,
    which need not be ``width / height``."""
    view = np.asarray(view_world_to_cam, np.float64)
    cam_pos = -view[:3, :3].T @ view[:3, 3]
    proj = perspective(tan_fovy, tan_fovx / tan_fovy, near, far) @ view
    return Camera.from_matrices(
        view=_FLIP_YZ @ view,
        proj=_FLIP_Y @ proj,
        cam_pos=cam_pos,
        tan_fovx=tan_fovx,
        tan_fovy=tan_fovy,
        width=width,
        height=height,
        device=device,
    )


def look_at_camera(
    eye,
    target,
    width: int,
    height: int,
    up=(0.0, 1.0, 0.0),
    fov_deg: float = 45.0,
    near: float = 0.2,
    far: float = 1000.0,
    device="cuda",
) -> Camera:
    """Camera at ``eye`` looking at ``target`` (OpenGL frame)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)

    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)

    # Camera basis: columns are camera axes in world space (-z forward).
    rot = np.stack([right, true_up, -fwd], axis=1)
    view = np.eye(4)
    view[:3, :3] = rot.T
    view[:3, 3] = rot.T @ (-eye)

    tan_fovx = np.tan(np.radians(fov_deg) / 2.0)
    tan_fovy = tan_fovx * height / width
    return _camera(view, eye, tan_fovx, tan_fovy, width, height, near, far, device)
