"""The port's COLMAP reader (tpusplat_torch/io/colmap.py) on the CPU against
the JAX package's, on the tiny sparse model that tests/test_colmap.py
writes: the parsed fields equal, the cameras within 1e-6, the seeded
Gaussians within 1e-6 and the k-NN scale init within rtol 1e-5 (with the
whole pool, a subsampled one and many chunks). The geometry checks of the
reference run on the port's preprocess."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_colmap import _make_fixture
from tpusplat.io import colmap as jcolmap
from tpusplat.types import to_numpy
from tpusplat_torch.config import SH_C0, RenderConfig
from tpusplat_torch.io import colmap
from tpusplat_torch.ops.preprocess import preprocess

torch.set_num_threads(2)

CAM_FIELDS = ("view", "proj", "cam_pos", "tan_fovx", "tan_fovy")


def _assert_cameras_close(got, want):
    assert (got.width, got.height) == (want.width, want.height)
    for f in CAM_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-6, err_msg=f)


def test_parse_roundtrip(tmp_path):
    root, (w, h, fx, fy) = _make_fixture(tmp_path)
    sparse = root / "sparse" / "0"
    cams = colmap.read_cameras_bin(str(sparse / "cameras.bin"))
    want = jcolmap.read_cameras_bin(str(sparse / "cameras.bin"))
    assert cams.keys() == want.keys()
    for k in cams:
        assert (cams[k].model, cams[k].width, cams[k].height, cams[k].focal) == \
            (want[k].model, want[k].width, want[k].height, want[k].focal)
        np.testing.assert_array_equal(cams[k].params, want[k].params)
    assert cams[1].model == "PINHOLE" and cams[1].focal == (fx, fy)
    assert cams[2].focal == (260.0, 260.0)

    images = colmap.read_images_bin(str(sparse / "images.bin"))
    want_im = jcolmap.read_images_bin(str(sparse / "images.bin"))
    assert [im.name for im in images] == [im.name for im in want_im] == \
        ["a_first.png", "b_second.png"]
    for a, b in zip(images, want_im):
        assert a.camera_id == b.camera_id
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)

    xyz, rgb = colmap.read_points3d_bin(str(sparse / "points3D.bin"))
    jxyz, jrgb = jcolmap.read_points3d_bin(str(sparse / "points3D.bin"))
    assert xyz.dtype == jxyz.dtype and rgb.dtype == jrgb.dtype
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(rgb, jrgb)
    assert tuple(rgb[0]) == (255, 128, 0)


def _scenes(root):
    got = colmap.load_colmap_scene(str(root), device="cpu")
    want = jcolmap.load_colmap_scene(str(root))
    assert got[1] == want[1]
    for a, b in zip(got[0], want[0]):
        _assert_cameras_close(a, b)
    return got, want


def test_geometry_center_projection(tmp_path):
    """A point straight ahead of the identity-pose camera projects to the
    image center at depth 5; a point at COLMAP y = -1 lands above it."""
    root, (w, h, fx, fy) = _make_fixture(tmp_path)
    (cams, names, init), _ = _scenes(root)
    cam = cams[names.index("b_second.png")]
    assert cam.width == w and cam.height == h
    np.testing.assert_allclose(float(cam.tan_fovx), w / (2 * fx), rtol=1e-6)
    np.testing.assert_allclose(float(cam.tan_fovy), h / (2 * fy), rtol=1e-6)
    pg = preprocess(init, cam, RenderConfig(sh_degree=0))
    np.testing.assert_allclose(float(pg.depth[0]), 5.0, rtol=1e-5)
    np.testing.assert_allclose(pg.uv[0].detach().numpy(), [(w - 1) / 2, (h - 1) / 2],
                               atol=1e-2)
    assert float(pg.uv[1, 0]) > (w - 1) / 2
    assert float(pg.uv[1, 1]) < (h - 1) / 2
    assert int(pg.ntiles[0]) > 0


def test_second_camera_depth(tmp_path):
    root, _ = _make_fixture(tmp_path)
    (cams, names, init), _ = _scenes(root)
    cam2 = cams[names.index("a_first.png")]
    pg = preprocess(init, cam2, RenderConfig(sh_degree=0))
    np.testing.assert_allclose(float(pg.depth[0]), 7.0, rtol=1e-5)
    np.testing.assert_allclose(cam2.cam_pos.numpy(), [0, 0, -2], atol=1e-6)


def test_init_from_points(tmp_path):
    root, _ = _make_fixture(tmp_path)
    (_, _, init), (_, _, want) = _scenes(root)
    assert init.num_gaussians == 3
    ref = dataclasses.asdict(to_numpy(want))
    for f, v in ref.items():
        if v.dtype == bool:
            np.testing.assert_array_equal(getattr(init, f).numpy(), v, err_msg=f)
        else:
            np.testing.assert_allclose(getattr(init, f).numpy(), v, rtol=0, atol=1e-6,
                                       err_msg=f)
    rgb0 = SH_C0 * init.sh[0, 0].numpy() + 0.5
    np.testing.assert_allclose(rgb0, [1.0, 128 / 255, 0.0], atol=1e-6)
    assert bool((init.sh[:, 1:] == 0).all())
    s = torch.exp(init.log_scales)
    assert bool(torch.isfinite(s).all() and (s > 0).all())
    assert bool((s[:, 0] == s[:, 1]).all() and (s[:, 0] == s[:, 2]).all())
    np.testing.assert_allclose(torch.sigmoid(init.opacities).numpy(), 0.1, rtol=1e-5)


def test_downscale(tmp_path):
    root, (w, h, fx, fy) = _make_fixture(tmp_path)
    sparse = str(root / "sparse" / "0")
    cams, names = colmap.load_colmap_cameras(sparse, downscale=2, device="cpu")
    want, want_names = jcolmap.load_colmap_cameras(sparse, downscale=2)
    assert names == want_names
    for a, b in zip(cams, want):
        _assert_cameras_close(a, b)
    cam = cams[names.index("b_second.png")]
    assert cam.width == w // 2 and cam.height == h // 2
    np.testing.assert_allclose(float(cam.tan_fovx), w / (2 * fx), rtol=1e-6)


@pytest.mark.parametrize("p,max_ref,budget", [
    (500, 20_000, colmap.KNN_BUDGET_BYTES),  # the whole cloud is the pool
    (3000, 1000, colmap.KNN_BUDGET_BYTES),   # a subsampled pool, the same draw
    (3000, 1000, 1 << 16),                   # four rows a chunk
])
def test_mean_knn_dist_matches_jax(p, max_ref, budget):
    xyz = np.random.default_rng(p).normal(0.0, 2.0, (p, 3)).astype(np.float32)
    got = colmap._mean_knn_dist(xyz, max_ref=max_ref, seed=3, device="cpu",
                                budget_bytes=budget)
    want = jcolmap._mean_knn_dist(xyz, max_ref=max_ref, seed=3)
    assert got.dtype == np.float32 and got.shape == (p,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
