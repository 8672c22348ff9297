"""Training datasets, (camera, image) pairs, and image IO (counterpart of
``tpusplat/io/dataset.py``).

Two formats besides COLMAP (:mod:`tpusplat_torch.io.colmap`):
  * a directory of ``.npz`` files with the keys view/proj/cam_pos/tan_fovx/
    tan_fovy/width/height/image (see :func:`save_view`);
  * NeRF-synthetic ``transforms_<split>.json``: ``camera_angle_x`` and per
    frame a camera-to-world ``transform_matrix`` in the OpenGL convention.

Images come back as float32 numpy arrays in [0, 1]; cameras are built on
``device``. PNGs are read with PIL where it is installed, otherwise with
the dependency-free decoder :func:`_read_png` (8-bit, not interlaced).
"""

from __future__ import annotations

import glob
import json
import os
import struct
import zlib

import numpy as np

from tpusplat_torch.camera import camera_from_world_view
from tpusplat_torch.types import Camera


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_view(path, camera: Camera, image) -> None:
    """One (camera, image) pair as an ``.npz`` view."""
    np.savez_compressed(
        path,
        view=_host(camera.view),
        proj=_host(camera.proj),
        cam_pos=_host(camera.cam_pos),
        tan_fovx=_host(camera.tan_fovx),
        tan_fovy=_host(camera.tan_fovy),
        width=camera.width,
        height=camera.height,
        image=np.asarray(_host(image), np.float32),
    )


def load_views(directory, device="cuda"):
    """Every ``.npz`` view of a directory, in name order -> (list[Camera],
    list[np.ndarray])."""
    cams, images = [], []
    for f in sorted(glob.glob(os.path.join(directory, "*.npz"))):
        with np.load(f) as d:
            cams.append(Camera.from_matrices(
                d["view"], d["proj"], d["cam_pos"], float(d["tan_fovx"]),
                float(d["tan_fovy"]), int(d["width"]), int(d["height"]), device=device))
            images.append(np.asarray(d["image"], np.float32))
    return cams, images


def load_nerf_synthetic(directory, split: str = "train", white_background: bool = False,
                        device="cuda"):
    """A NeRF-synthetic dataset (``transforms_<split>.json``, else
    ``transforms.json``, and its PNGs) -> (list[Camera], list[np.ndarray
    [H, W, 3] in [0, 1]]). RGBA images are composited over black (white
    with ``white_background``). The transform is camera-to-world with
    OpenGL axes, the camera frame before the shader flips, so the view
    matrix is its inverse."""
    path = os.path.join(directory, f"transforms_{split}.json")
    if not os.path.exists(path):
        path = os.path.join(directory, "transforms.json")
    with open(path) as f:
        meta = json.load(f)
    cam_angle_x = float(meta["camera_angle_x"])

    cams, images = [], []
    for frame in meta["frames"]:
        img_path = os.path.join(directory, frame["file_path"])
        if not os.path.splitext(img_path)[1]:
            img_path += ".png"
        img = _read_png(img_path)
        if img.shape[-1] == 4:
            alpha = img[..., 3:4]
            bg = 1.0 if white_background else 0.0
            img = img[..., :3] * alpha + bg * (1 - alpha)
        h, w = img.shape[:2]
        tan_fovx = np.tan(cam_angle_x / 2)
        tan_fovy = tan_fovx * h / w
        w2c = np.linalg.inv(np.asarray(frame["transform_matrix"], np.float64))
        cams.append(camera_from_world_view(w2c, w, h, tan_fovx, tan_fovy, device=device))
        images.append(img.astype(np.float32))
    return cams, images


def save_png(path, img) -> None:
    """Write [H, W, 3] floats in [0, 1] (a tensor on any device, or an
    array) as an 8-bit RGB PNG, with no dependencies."""
    arr = np.round(np.clip(_host(img), 0.0, 1.0) * 255.0).astype(np.uint8)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, body):
        out = struct.pack(">I", len(body)) + tag + body
        return out + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    png = b"\x89PNG\r\n\x1a\n"
    png += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    png += chunk(b"IDAT", zlib.compress(raw, 6))
    png += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


def read_image(path) -> np.ndarray:
    """An image file as [H, W, C] floats in [0, 1] (PIL when installed, any
    format; otherwise the dependency-free PNG decoder)."""
    return _read_png(path)


def is_colmap(directory) -> bool:
    return os.path.isdir(os.path.join(directory, "sparse"))


def is_nerf_synthetic(directory) -> bool:
    return any(os.path.exists(os.path.join(directory, f"transforms{s}.json"))
               for s in ("_train", ""))


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels (no palette)


def _read_png(path) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        return _decode_png(path)
    with Image.open(path) as im:
        return np.asarray(im, np.float32) / 255.0


def _decode_png(path) -> np.ndarray:
    """8-bit, non-interlaced grey, grey-alpha, RGB or RGBA PNG, no
    dependencies. The Sub and Up filters are undone a whole row at a time;
    Average and Paeth, whose every byte depends on the one decoded before
    it, one byte at a time."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat = 8, []
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
                raise ValueError(f"{path}: unsupported PNG variant (bit depth {depth}, "
                                 f"colour type {ctype}, interlace {interlace})")
            channels = _CHANNELS[ctype]
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if channels is None:
        raise ValueError(f"{path}: no IHDR chunk")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * channels
    if raw.shape[0] < h * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:  # None
            cur = line
        elif ftype == 1:  # Sub: a running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(w, channels), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev  # uint8 wraps modulo 256
        elif ftype in (3, 4):
            cur = np.asarray(_unfilter_scalar(ftype, line.tolist(), prev.tolist(), channels),
                             np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, channels).astype(np.float32) / 255.0


def _unfilter_scalar(ftype: int, cur: list, up: list, channels: int) -> list:
    """Undo the Average (3) or Paeth (4) filter of one row, in place on the
    list ``cur``; ``up`` is the row above, decoded."""
    if ftype == 3:
        for i in range(len(cur)):
            left = cur[i - channels] if i >= channels else 0
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
        return cur
    for i in range(len(cur)):
        if i >= channels:
            a, c = cur[i - channels], up[i - channels]
        else:
            a = c = 0
        b = up[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pr) & 0xFF
    return cur
