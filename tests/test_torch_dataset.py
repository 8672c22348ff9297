"""The port's dataset IO (tpusplat_torch/io/dataset.py) on the CPU against
the JAX package's (the counterpart of tests/test_dataset.py): ``.npz``
views both ways, the PNG codec pair, the dependency-free decoder on every
PNG filter type against the reference decoder and the true pixels, and
NeRF-synthetic cameras within 1e-6 of the reference's."""

import json
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.io import dataset as jdataset
from tpusplat_torch.camera import look_at_camera
from tpusplat_torch.io import dataset

torch.set_num_threads(2)


def _assert_cameras_close(got, want, atol=1e-6):
    assert (got.width, got.height) == (want.width, want.height)
    for f in ("view", "proj", "cam_pos", "tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=atol, err_msg=f)


def test_view_roundtrip(tmp_path):
    cam = look_at_camera([1, 2, 3], [0, 0, 0], 64, 48, device="cpu")
    img = np.random.default_rng(0).uniform(0, 1, (48, 64, 3)).astype(np.float32)
    dataset.save_view(tmp_path / "v0.npz", cam, torch.from_numpy(img))
    jdataset.save_view(tmp_path / "v1.npz", jax_look_at([1, 2, 3], [0, 0, 0], 64, 48), img)
    cams, images = dataset.load_views(str(tmp_path), device="cpu")
    want_cams, _ = jdataset.load_views(str(tmp_path))
    assert len(cams) == 2 and cams[0].width == 64 and cams[0].height == 48
    for got, want in zip(cams, want_cams):
        _assert_cameras_close(got, want, atol=0)
    np.testing.assert_array_equal(cams[0].view.numpy(), cam.view.numpy())
    np.testing.assert_array_equal(images[0], img)
    np.testing.assert_array_equal(images[1], img)


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(1).uniform(0, 1, (17, 23, 3)).astype(np.float32)
    dataset.save_png(tmp_path / "x.png", torch.from_numpy(img))
    back = dataset._read_png(str(tmp_path / "x.png"))
    np.testing.assert_array_equal(back, jdataset._read_png(str(tmp_path / "x.png")))
    expect = np.round(np.clip(img, 0, 1) * 255) / 255.0
    np.testing.assert_allclose(back, expect, atol=1 / 255.0 + 1e-6)
    assert (tmp_path / "x.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _write_filtered_png(path, arr, ftype):
    """[H, W, C] uint8 as a PNG whose every row uses filter ``ftype``."""
    h, w, ch = arr.shape
    rows = arr.reshape(h, w * ch).astype(int)
    body = b""
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        out = []
        for i in range(w * ch):
            a = cur[i - ch] if i >= ch else 0
            c = up[i - ch] if i >= ch else 0
            pred = (0, a, up[i], (a + up[i]) >> 1, _paeth(a, up[i], c))[ftype]
            out.append((cur[i] - pred) & 0xFF)
        body += bytes([ftype, *out])

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ctype = {3: 2, 4: 6}[ch]
    ihdr = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + ihdr + chunk(b"IDAT", zlib.compress(body))
                     + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decoder_on_every_filter_type(tmp_path, monkeypatch, ftype):
    """Without PIL both packages take their own decoder: equal arrays, equal
    to the true pixels, in RGB and RGBA."""
    rng = np.random.default_rng(ftype)
    monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` raises
    for ch in (3, 4):
        arr = rng.integers(0, 256, (7, 11, ch), dtype=np.uint8)
        arr[2] = arr[1]  # repeated rows and pixels, where the predictors agree
        arr[:, 5] = arr[:, 4]
        path = tmp_path / f"f{ftype}_{ch}.png"
        _write_filtered_png(path, arr, ftype)
        got = dataset._read_png(str(path))
        np.testing.assert_array_equal(got, jdataset._read_png(str(path)))
        np.testing.assert_array_equal(got, arr.astype(np.float32) / 255.0)


def test_nerf_synthetic_loader(tmp_path):
    img = np.zeros((32, 32, 3), np.float32)
    img[8:24, 8:24] = 0.5
    dataset.save_png(tmp_path / "r0.png", img)
    c2w = np.eye(4)
    c2w[2, 3] = 4.0  # camera at z=+4 looking down -z (OpenGL)
    c2w_b = np.array([[0.8, 0.0, 0.6, 2.4], [0.0, 1.0, 0.0, 0.5], [-0.6, 0.0, 0.8, 3.2],
                      [0.0, 0.0, 0.0, 1.0]])
    meta = dict(camera_angle_x=0.8, frames=[
        dict(file_path="r0", transform_matrix=c2w.tolist()),
        dict(file_path="r0.png", transform_matrix=c2w_b.tolist()),
    ])
    (tmp_path / "transforms_train.json").write_text(json.dumps(meta))
    assert dataset.is_nerf_synthetic(str(tmp_path)) and not dataset.is_colmap(str(tmp_path))

    cams, images = dataset.load_nerf_synthetic(str(tmp_path), "train", device="cpu")
    want_cams, want_images = jdataset.load_nerf_synthetic(str(tmp_path), "train")
    assert len(cams) == 2
    for got, want in zip(cams, want_cams):
        _assert_cameras_close(got, want)
    np.testing.assert_array_equal(images[0], want_images[0])
    np.testing.assert_allclose(images[0], np.round(img * 255) / 255, atol=1e-6)
    # A point at the origin projects to the image center at depth 4.
    p = np.array([0.0, 0.0, 0.0, 1.0])
    assert np.isclose((cams[0].view.double().numpy() @ p)[2], 4.0, atol=1e-6)
    ph = cams[0].proj.double().numpy() @ p
    np.testing.assert_allclose(ph[:2] / ph[3], 0.0, atol=1e-6)
