"""COLMAP binary model ingestion: ``cameras.bin``, ``images.bin`` and
``points3D.bin`` (counterpart of ``tpusplat/io/colmap.py``).

The standard real-scene input of 3DGS training (Mip-NeRF 360 and others):
the camera intrinsics and poses of the supervision views, and the SfM point
cloud that seeds the model. The format is COLMAP's
``src/colmap/scene/reconstruction_io.cc`` (little-endian, no alignment).

COLMAP's camera frame is OpenCV's (+x right, +y down, +z forward);
:func:`tpusplat_torch.camera.camera_from_world_view` takes the OpenGL frame
(+x right, +y up, -z forward), so rows 1 and 2 of the world-to-camera
matrix are negated here. The matrices are built in float64 numpy, as in the
JAX package; the cameras and the seeded parameters land on ``device``.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np
import torch

from tpusplat_torch.camera import camera_from_world_view, quat_to_rotmat
from tpusplat_torch.config import SH_C0
from tpusplat_torch.types import Camera, GaussianParams, resolve_device

# model_id -> (name, num_params). SIMPLE_* and the radial models have one
# focal (params[0]); the others start with fx, fy (colmap/src/colmap/sensor/models.h).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific: [f, cx, cy] or [fx, fy, cx, cy, ...]

    @property
    def focal(self) -> tuple[float, float]:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            return float(self.params[0]), float(self.params[0])
        return float(self.params[0]), float(self.params[1])


@dataclasses.dataclass
class ColmapImage:
    name: str
    qvec: np.ndarray  # (w, x, y, z) world-to-camera rotation
    tvec: np.ndarray  # world-to-camera translation
    camera_id: int


def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> dict[int, ColmapCamera]:
    cams: dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            if model_id not in CAMERA_MODELS:
                raise ValueError(f"{path}: unknown COLMAP camera model id {model_id}")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(name, int(width), int(height), params)
    return cams


def read_images_bin(path: str) -> list[ColmapImage]:
    """The registered images, sorted by name."""
    images: list[ColmapImage] = []
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            _read(f, "<i")  # image id
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (camera_id,) = _read(f, "<i")
            name = b""
            while (c := f.read(1)) != b"\x00":
                if not c:
                    raise ValueError(f"{path}: truncated image name")
                name += c
            (n_pts2d,) = _read(f, "<Q")
            f.seek(n_pts2d * 24, os.SEEK_CUR)  # (x, y double, point3D_id i64)
            images.append(ColmapImage(name.decode(), qvec, tvec, camera_id))
    images.sort(key=lambda im: im.name)
    return images


def read_points3d_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (xyz [P, 3] float64, rgb [P, 3] uint8)."""
    xyz, rgb = [], []
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            _read(f, "<Q")  # point id
            xyz.append(_read(f, "<3d"))
            rgb.append(_read(f, "<3B"))
            _read(f, "<d")  # reprojection error
            (track_len,) = _read(f, "<Q")
            f.seek(track_len * 8, os.SEEK_CUR)  # (image_id i32, p2d_idx i32)
    return (np.asarray(xyz, np.float64).reshape(-1, 3),
            np.asarray(rgb, np.uint8).reshape(-1, 3))


_CV_TO_GL = np.diag([1.0, -1.0, -1.0])  # +y down/+z forward -> +y up/-z forward


def colmap_to_camera(img: ColmapImage, cam: ColmapCamera, downscale: int = 1,
                     device="cuda") -> Camera:
    """One supervision Camera from a COLMAP (image, camera) pair."""
    r = quat_to_rotmat(img.qvec)  # world -> camera (OpenCV frame)
    w2c = np.eye(4)
    w2c[:3, :3] = _CV_TO_GL @ r
    w2c[:3, 3] = _CV_TO_GL @ img.tvec
    fx, fy = cam.focal
    # The focal scales with the resolution; tan_fov = size / (2 focal) does not.
    tan_fovx = cam.width / (2.0 * fx)
    tan_fovy = cam.height / (2.0 * fy)
    return camera_from_world_view(w2c, cam.width // downscale, cam.height // downscale,
                                  tan_fovx, tan_fovy, device=device)


def load_colmap_cameras(sparse_dir: str, downscale: int = 1,
                        device="cuda") -> tuple[list[Camera], list[str]]:
    """Every registered view of a sparse model, sorted by image name.

    Returns (cameras, image file names); the names pair with an ``images/``
    directory (or ``images_<downscale>/``) holding the targets."""
    cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    images = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    out = [colmap_to_camera(im, cams[im.camera_id], downscale, device) for im in images]
    return out, [im.name for im in images]


# Bytes of one chunk's [chunk, pool] float32 work in _mean_knn_dist (the
# squared distances and the temporaries of one coordinate), at most.
KNN_BUDGET_BYTES = 1 << 30


def _mean_knn_dist(xyz: np.ndarray, k: int = 3, max_ref: int = 20_000, seed: int = 0,
                   device="cuda", budget_bytes: int = KNN_BUDGET_BYTES) -> np.ndarray:
    """Mean distance to the k nearest neighbours, brute force on ``device``
    in chunks of rows that keep the chunk's work within ``budget_bytes``.

    The neighbour pool is the JAX package's: every point, or ``max_ref`` of
    them drawn by ``default_rng(seed).choice`` for a larger cloud. As there,
    the nearest entry of the pool is dropped as the point itself, also when
    the point is not in a subsampled pool. Returns float32 [P] on the host.
    """
    p = xyz.shape[0]
    rng = np.random.default_rng(seed)
    ref = xyz if p <= max_ref else xyz[rng.choice(p, max_ref, replace=False)]
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(xyz, np.float32), device=dev)
    r = torch.as_tensor(np.asarray(ref, np.float32), device=dev)
    m = r.shape[0]
    kk = min(k + 1, m)  # +1: the point itself is in a whole pool, at distance 0
    chunk = max(1, budget_bytes // (16 * max(m, 1)))
    out = torch.empty(p, dtype=torch.float32, device=dev)
    for i in range(0, p, chunk):
        xc = x[i:i + chunk]
        d2 = (xc[:, None, 0] - r[None, :, 0]) ** 2
        d2 += (xc[:, None, 1] - r[None, :, 1]) ** 2
        d2 += (xc[:, None, 2] - r[None, :, 2]) ** 2
        part = torch.topk(d2, kk, dim=1, largest=False, sorted=True).values
        if m > 1:
            part = part[:, 1:]
        out[i:i + chunk] = torch.sqrt(torch.clamp_min(part, 0.0)).mean(1)
    return out.cpu().numpy()


def init_from_points(xyz: np.ndarray, rgb: np.ndarray, sh_degree: int = 3,
                     init_opacity: float = 0.1, seed: int = 0,
                     device="cuda") -> GaussianParams:
    """Gaussians seeded from an SfM point cloud, the 3DGS recipe: means at
    the points, SH DC from the point colour (``dc = (rgb - 0.5) / SH_C0``),
    isotropic scales at the mean 3-NN distance, identity rotations and a
    uniform low opacity. ``sh_degree`` is accepted as in the JAX package;
    only the DC term is set."""
    n = xyz.shape[0]
    means = np.asarray(xyz, np.float32)
    dist = np.clip(_mean_knn_dist(means, seed=seed, device=device), 1e-7, None)
    log_scales = np.tile(np.log(dist)[:, None], (1, 3)).astype(np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    op = float(init_opacity)
    opacities = np.full(n, np.log(op / (1.0 - op)), np.float32)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = (np.asarray(rgb, np.float32) / 255.0 - 0.5) / SH_C0
    return GaussianParams.create(means=means, log_scales=log_scales, quats=quats,
                                 opacities=opacities, sh=sh, device=device)


def load_colmap_scene(root: str, downscale: int = 1, device="cuda"):
    """A COLMAP capture directory in one call: ``root`` holds ``sparse/0``
    (or ``sparse``) with the three ``.bin`` files. Returns (cameras,
    image_names, init_params), on ``device``."""
    sparse = os.path.join(root, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(root, "sparse")
    cams, names = load_colmap_cameras(sparse, downscale, device)
    xyz, rgb = read_points3d_bin(os.path.join(sparse, "points3D.bin"))
    return cams, names, init_from_points(xyz, rgb, device=device)
