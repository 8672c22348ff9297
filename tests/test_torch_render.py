"""The port's render pipeline on the CPU against the JAX package: the
Pallas path (interpret mode) and the XLA path at the settings of
tests/test_pallas_rasterize.py, the golden snapshot at the settings of
tests/test_snapshot.py, render_auto's regrow, and the device contract."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.render import render_stages as jax_render_stages
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.camera import look_at_camera
from tpusplat_torch.config import RenderConfig, regrow
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.ops import rasterize
from tpusplat_torch.render import (
    render,
    render_auto,
    render_batch,
    render_profiled,
    render_stages,
)

torch.set_num_threads(2)


def _port(params, cam):
    p, c = to_numpy(params), to_numpy(cam)
    tp = convert.params_from_numpy(p.means, p.log_scales, p.quats, p.opacities, p.sh,
                                   p.alive, device="cpu")
    tc = convert.camera_from_numpy(c.view, c.proj, c.cam_pos, c.tan_fovx, c.tan_fovy,
                                   c.width, c.height, device="cpu")
    return tp, tc


def _setup(n=400, w=64, h=48, sh_degree=1, seed=6, use_pallas=False):
    params = jax_random_scene(n, seed=seed, sh_degree=sh_degree, scale_range=(0.05, 0.3))
    cam = jax_look_at([0.3, 0.2, 6.0], [0, 0, 0], w, h, fov_deg=60.0)
    cfg = JaxConfig(sh_degree=sh_degree, max_per_tile=512, tile_chunk=4, gauss_chunk=16,
                    use_pallas=use_pallas)
    return params, cam, cfg


@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_matches_jax(use_pallas):
    params, cam, cfg = _setup(use_pallas=use_pallas)
    img_j, aux_j = jax_render_stages(params, cam, cfg)
    tp, tc = _port(params, cam)
    img, aux = render_stages(tp, tc, convert.config_from_fields(dataclasses.asdict(cfg)))
    assert int(aux["capacity_overflow"]) == 0
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(aux["transmittance"].numpy(),
                               np.asarray(aux_j["transmittance"]), atol=3e-5)
    for k in ("num_instances", "capacity_overflow", "gauss_overflow", "tile_overflow"):
        assert int(aux[k]) == int(aux_j[k]), k
    np.testing.assert_array_equal(aux["visible"].numpy(), np.asarray(aux_j["visible"]))
    if use_pallas:
        assert int(aux["max_tile_count"]) == int(aux_j["max_tile_count"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_dense_overlap_matches_jax(use_pallas):
    # Big scales: hundreds of instances a tile, many batches and chunks.
    params, cam, cfg = _setup(n=800, w=32, h=32, use_pallas=use_pallas)
    params = dataclasses.replace(params, log_scales=params.log_scales + 1.5)
    cfg = dataclasses.replace(cfg, max_per_tile=1024)
    img_j, _ = jax_render_stages(params, cam, cfg)
    tp, tc = _port(params, cam)
    img, aux = render_stages(tp, tc, convert.config_from_fields(dataclasses.asdict(cfg)))
    assert int(aux["max_tile_count"]) > 256
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=1e-4, rtol=1e-3)


def test_render_matches_snapshot():
    params = random_scene(400, seed=11, sh_degree=2, scale_range=(0.05, 0.25), device="cpu")
    cam = look_at_camera([0.5, 0.3, 6.0], [0, 0, 0], 96, 64, fov_deg=60.0, device="cpu")
    cfg = RenderConfig(sh_degree=2, max_per_tile=256, tile_chunk=4)
    img = render(params, cam, cfg)
    ref = np.load(pathlib.Path(__file__).parent / "golden_snapshot.npz")["image"]
    np.testing.assert_allclose(img.numpy(), ref, atol=5e-5, rtol=1e-4)


def test_render_auto_regrows_to_the_same_image():
    params = random_scene(400, seed=11, sh_degree=2, scale_range=(0.05, 0.25), device="cpu")
    cam = look_at_camera([0.5, 0.3, 6.0], [0, 0, 0], 96, 64, fov_deg=60.0, device="cpu")
    cfg = RenderConfig(sh_degree=2, max_per_tile=256, tile_chunk=4)
    img_ref, aux_ref = render_stages(params, cam, cfg)
    small = dataclasses.replace(cfg, capacity=1024)
    _, aux_small = render_stages(params, cam, small)
    assert int(aux_small["capacity_overflow"]) > 0
    img, aux, grown = render_auto(params, cam, small)
    assert int(aux["capacity_overflow"]) == 0
    assert grown.instance_capacity(400) >= int(aux_ref["num_instances"])
    np.testing.assert_array_equal(img.numpy(), img_ref.numpy())


def test_render_profiled_matches_render_stages():
    params, cam, cfg = _setup(n=200, w=32, h=32)
    tp, tc = _port(params, cam)
    tcfg = convert.config_from_fields(dataclasses.asdict(cfg))
    img, _ = render_stages(tp, tc, tcfg)
    img_p, aux_p, stage_ms = render_profiled(tp, tc, tcfg)
    assert set(stage_ms) == {"preprocess", "bin+sort", "raster"}
    assert all(v >= 0.0 for v in stage_ms.values())
    assert "radius" in aux_p and "visible" in aux_p
    np.testing.assert_array_equal(img_p.numpy(), img.numpy())


def test_render_batch_matches_individual():
    """tests/test_render_vs_golden.py::test_render_batch_matches_individual:
    each image bit-equal to its own render_stages, and the batch within this
    file's bound of the JAX render_batch."""
    import jax

    from tpusplat.render import render_batch as jax_render_batch
    from tpusplat.types import stack_cameras

    params = jax_random_scene(200, seed=3, sh_degree=0)
    jcams = [jax_look_at([i - 1.0, 0, 6.0], [0, 0, 0], 64, 64) for i in range(3)]
    cfg = JaxConfig(sh_degree=0, max_per_tile=128, tile_chunk=4)
    want = np.asarray(jax.jit(jax_render_batch, static_argnames="cfg")(
        params, stack_cameras(jcams), cfg))
    tcfg = convert.config_from_fields(dataclasses.asdict(cfg))
    tp, _ = _port(params, jcams[0])
    cams = [_port(params, c)[1] for c in jcams]
    batch = render_batch(tp, cams, tcfg)
    assert batch.shape == (3, 64, 64, 3)
    for i, cam in enumerate(cams):
        assert torch.equal(batch[i], render_stages(tp, cam, tcfg)[0])
    np.testing.assert_allclose(batch.numpy(), want, atol=3e-5, rtol=1e-4)
    small = look_at_camera([0, 0, 6.0], [0, 0, 0], 32, 64, device="cpu")
    with pytest.raises(ValueError, match="one resolution"):
        render_batch(tp, [cams[0], small], tcfg)


def test_render_is_differentiable_on_cpu():
    params = random_scene(150, seed=2, sh_degree=1, scale_range=(0.05, 0.3), device="cpu")
    cam = look_at_camera([0.0, 0.0, 6.0], [0, 0, 0], 32, 32, fov_deg=60.0, device="cpu")
    means = params.means.clone().requires_grad_(True)
    img = render(dataclasses.replace(params, means=means), cam, RenderConfig(sh_degree=1))
    img.sum().backward()
    assert torch.isfinite(means.grad).all() and means.grad.abs().sum() > 0


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_scene(16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        look_at_camera([0, 0, 5.0], [0, 0, 0], 32, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_numpy(np.zeros((2, 3)), np.zeros((2, 3)), np.ones((2, 4)),
                                  np.zeros(2), np.zeros((2, 16, 3)))


def test_config_contract():
    cfg = convert.config_from_fields(dataclasses.asdict(JaxConfig(use_pallas=True)))
    assert not hasattr(cfg, "use_pallas")
    assert cfg == RenderConfig()
    with pytest.raises(ValueError):
        RenderConfig(mm_precision="Highest")
    with pytest.raises(ValueError):
        convert.config_from_fields({"no_such_field": 1})
    params = random_scene(20, seed=0, device="cpu")
    cam = look_at_camera([0, 0, 5.0], [0, 0, 0], 32, 32, device="cpu")
    _, aux = render_stages(params, cam, RenderConfig(debug_checks=True))
    assert aux["debug"] and all(int(v) == 0 for v in aux["debug"].values())
    grown, log = regrow(RenderConfig(), {"capacity_overflow": torch.tensor(100),
                                         "tile_overflow": np.array([1, 2])}, 1000)
    assert grown.capacity == int((8192 + 100) * 1.3) and grown.max_per_tile == 2048
    assert log["capacity_overflow"] == 100 and log["tile_overflow"] == 3
    assert regrow(RenderConfig(), {}, 1000) == (RenderConfig(), None)


def test_env_overrides(monkeypatch):
    monkeypatch.setenv("TPUSPLAT_TIGHT_RADIUS", "1")
    monkeypatch.setenv("TPUSPLAT_MAX_PER_TILE", "2048")
    monkeypatch.setenv("TPUSPLAT_USE_PALLAS", "0")
    cfg = RenderConfig().with_env_overrides()
    assert cfg.tight_radius and cfg.max_per_tile == 2048
    monkeypatch.setenv("TPUSPLAT_MM_PRECISION", "Highest")
    with pytest.raises(ValueError):
        RenderConfig().with_env_overrides()


def test_forward_blend_uses_plain_version_on_cpu():
    params = random_scene(100, seed=1, sh_degree=0, scale_range=(0.05, 0.3), device="cpu")
    cam = look_at_camera([0.0, 0.0, 6.0], [0, 0, 0], 32, 32, fov_deg=60.0, device="cpu")
    before = rasterize.FORWARD_LAUNCHES
    img, aux = render_stages(params, cam, RenderConfig(sh_degree=0))
    assert rasterize.FORWARD_LAUNCHES == before
    assert img.shape == (32, 32, 3) and aux["transmittance"].shape == (32, 32)
