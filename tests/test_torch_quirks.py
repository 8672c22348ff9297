"""The reference's parity quirks and oracle checks, on the port's CPU path:

  * the eight cases of tests/test_parity_quirks.py (dilation, eigenvalue
    floor, near-plane cull, Jacobian clamp, the 0.99 alpha clamp,
    termination before the add, the 1/255 cutoff, camera defaults);
  * the two configs of tests/test_render_vs_golden.py against the JAX
    package's sequential golden oracle (bound 2e-4);
  * tests/test_regrow.py's tight-radius cases (image and gradients
    unchanged; sub-cutoff opacities fully culled);
  * tests/test_gradients.py's finite differences (means, opacities, sh).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpusplat_torch import convert
from tpusplat_torch.camera import look_at_camera, make_camera
from tpusplat_torch.config import SH_C0, RenderConfig
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.ops.preprocess import preprocess
from tpusplat_torch.render import render_stages
from tpusplat_torch.types import GaussianParams

torch.set_num_threads(2)

FIELDS = ("means", "log_scales", "quats", "opacities", "sh")


def _one_gaussian(pos, scale=0.1, opacity_raw=4.0, dc=(1.0, 1.0, 1.0)):
    sh = np.zeros((1, 16, 3), np.float32)
    sh[0, 0] = (np.asarray(dc) - 0.5) / SH_C0
    return GaussianParams.create(
        means=np.asarray([pos], np.float32),
        log_scales=np.log(np.full((1, 3), scale, np.float32)),
        quats=np.asarray([[1, 0, 0, 0]], np.float32),
        opacities=np.asarray([opacity_raw], np.float32), sh=sh, device="cpu")


CAM = look_at_camera([0, 0, 5.0], [0, 0, 0], 64, 64, fov_deg=60.0, device="cpu")
CFG = RenderConfig(sh_degree=0, max_per_tile=64, tile_chunk=4)


def test_covariance_dilation_floor():
    """A tiny Gaussian's 2D covariance is the +0.3 dilation (conic ~ 1/0.3);
    the eigenvalue floor keeps its radius positive."""
    pg = preprocess(_one_gaussian([0, 0, 0], scale=1e-4), CAM, CFG)
    conic = pg.conic[0].detach().numpy()
    np.testing.assert_allclose(conic[0], 1 / 0.3, rtol=1e-3)
    np.testing.assert_allclose(conic[2], 1 / 0.3, rtol=1e-3)
    assert float(pg.radius[0]) >= np.ceil(3 * np.sqrt(0.3))


def test_radius_eigenvalue_floor_exact():
    """Isotropic splat: lambda = sigma2d + sqrt(max(0.1, 0))."""
    pg = preprocess(_one_gaussian([0, 0, 0], scale=0.05), CAM, CFG)
    f = 64 / (2 * float(CAM.tan_fovx))
    lam = (0.05 * f / 5.0) ** 2 + 0.3 + np.sqrt(0.1)
    np.testing.assert_allclose(float(pg.radius[0]), np.ceil(3 * np.sqrt(lam)))


def test_near_plane_cull_boundary():
    """Cull at view depth <= 0.2 whatever the near plane."""
    for z, visible in ((4.81, False), (4.75, True)):
        pg = preprocess(_one_gaussian([0, 0, z], scale=0.05), CAM, CFG)
        assert (int(pg.ntiles[0]) > 0) == visible, z


def test_jacobian_clamp_at_frustum_edge():
    """txtz clamps at 1.3 tan_fov: one Gaussian far outside the cone gets
    the Jacobian of one at the clamp (the same conic determinant)."""
    t = float(CAM.tan_fovx)
    depth = 5.0 - 1.0
    ce = preprocess(_one_gaussian([1.3 * t * depth, 0, 1.0], scale=0.05), CAM, CFG).conic[0]
    co = preprocess(_one_gaussian([2.5 * t * depth, 0, 1.0], scale=0.05), CAM, CFG).conic[0]
    ce, co = ce.detach().double(), co.detach().double()
    np.testing.assert_allclose(float(ce[0] * ce[2] - ce[1] ** 2),
                               float(co[0] * co[2] - co[1] ** 2), rtol=1e-4)


def test_alpha_clamp_099():
    """alpha = min(0.99, ...): an opaque Gaussian contributes 0.99, T 0.01."""
    params = _one_gaussian([0, 0, 1.0], opacity_raw=20.0, dc=(1, 0, 0))
    params = dataclasses.replace(params, log_scales=torch.full((1, 3), float(np.log(5.0))))
    img, aux = render_stages(params, CAM, CFG)
    np.testing.assert_allclose(float(img[32, 32, 0]), 0.99, atol=1e-4)
    np.testing.assert_allclose(float(aux["transmittance"][32, 32]), 0.01, rtol=1e-4)


def test_termination_before_add():
    """The Gaussian that would push T below 1e-4 is not blended; the aux T
    is the full product over passing Gaussians."""
    logit = float(np.log(0.95 / 0.05))
    colors = [(1, 0, 0), (0, 1, 0), (0, 0, 0.5), (0, 0, 1)]
    gs = [_one_gaussian([0, 0, 1.0 - 0.5 * i], opacity_raw=logit, dc=c)
          for i, c in enumerate(colors)]
    params = GaussianParams.create(
        means=torch.cat([g.means for g in gs]).numpy(),
        log_scales=np.full((4, 3), np.log(5.0), np.float32),
        quats=torch.cat([g.quats for g in gs]).numpy(),
        opacities=torch.cat([g.opacities for g in gs]).numpy(),
        sh=torch.cat([g.sh for g in gs]).numpy(), device="cpu")
    img, aux = render_stages(params, CAM, CFG)
    center = img[32, 32].numpy()
    np.testing.assert_allclose(center[0], 0.95, atol=1e-4)
    np.testing.assert_allclose(center[1], 0.95 * 0.05, rtol=1e-3)
    np.testing.assert_allclose(center[2], 0.5 * 0.95 * 0.0025, rtol=1e-2)
    np.testing.assert_allclose(float(aux["transmittance"][32, 32]), 0.05**4, rtol=1e-2)


def test_min_alpha_cutoff():
    """Contributions below 1/255 are skipped entirely."""
    a = 1 / 255.0 * 0.999
    img, _ = render_stages(_one_gaussian([0, 0, 0], opacity_raw=np.log(a / (1 - a))), CAM, CFG)
    assert float(img.max()) == 0.0


def test_reference_camera_pose_matches_viewer_defaults():
    """make_camera's defaults (fov 45, near 0.2, far 1000)."""
    cam = make_camera([0, 0, 0], [1, 0, 0, 0], 1280, 720, device="cpu")
    assert np.isclose(float(cam.tan_fovx), np.tan(np.radians(45.0) / 2))
    assert np.isclose(float(cam.tan_fovy), float(cam.tan_fovx) * 720 / 1280)


@pytest.mark.parametrize("n,w,h,sh_degree,seed",
                         [(300, 128, 128, 0, 0), (1000, 160, 120, 3, 1)])
def test_forward_matches_golden(n, w, h, sh_degree, seed):
    """The JAX package's sequential oracle on the same scene and camera."""
    from tpusplat.camera import look_at_camera as jax_look_at
    from tpusplat.config import RenderConfig as JaxConfig
    from tpusplat.io.synthetic import random_scene as jax_random_scene
    from tpusplat.ops.golden import golden_render

    jparams = jax_random_scene(n, seed=seed, sh_degree=sh_degree)
    jcam = jax_look_at([0.0, 0.5, 7.0], [0.0, 0.0, 0.0], w, h, fov_deg=55.0)
    jcfg = JaxConfig(sh_degree=sh_degree, max_per_tile=512, tile_chunk=16)
    gold = golden_render(jparams, jcam, jcfg)

    params = random_scene(n, seed=seed, sh_degree=sh_degree, device="cpu")
    cam = look_at_camera([0.0, 0.5, 7.0], [0.0, 0.0, 0.0], w, h, fov_deg=55.0, device="cpu")
    img, aux = render_stages(params, cam, convert.config_from_fields(dataclasses.asdict(jcfg)))
    assert int(aux["capacity_overflow"]) == 0 and int(aux["tile_overflow"]) == 0
    assert img.shape == gold.shape
    np.testing.assert_allclose(img.numpy(), gold, atol=2e-4, rtol=1e-3)


def _regrow_setup(n, seed):
    params = random_scene(n, seed=seed, sh_degree=1, scale_range=(0.05, 0.3), device="cpu")
    cam = look_at_camera([0.2, 0.1, 6.0], [0, 0, 0], 64, 48, fov_deg=60.0, device="cpu")
    return params, cam


def _grads(params, cam, cfg, target):
    leaves = {f: getattr(params, f).detach().clone().requires_grad_(True) for f in FIELDS}
    img, aux = render_stages(dataclasses.replace(params, **leaves), cam, cfg)
    grads = torch.autograd.grad(torch.mean((img - target) ** 2), [leaves[f] for f in FIELDS])
    return img.detach(), aux, dict(zip(FIELDS, grads))


def test_tight_radius_image_and_grads_identical():
    params, cam = _regrow_setup(250, 9)
    params = dataclasses.replace(params, opacities=params.opacities - 2.0)
    loose = RenderConfig(sh_degree=1, capacity_mult=128, max_per_tile=2048, tile_chunk=4,
                         gauss_chunk=16, tight_radius=False)
    tight = dataclasses.replace(loose, tight_radius=True)
    target = torch.full((48, 64, 3), 0.25)
    img_l, aux_l, g_l = _grads(params, cam, loose, target)
    img_t, aux_t, g_t = _grads(params, cam, tight, target)
    assert int(aux_l["capacity_overflow"]) == 0 and int(aux_l["tile_overflow"]) == 0
    assert int(aux_t["num_instances"]) < int(aux_l["num_instances"])
    np.testing.assert_allclose(img_t.numpy(), img_l.numpy(), atol=5e-7)
    for f in FIELDS:
        np.testing.assert_allclose(g_t[f].numpy(), g_l[f].numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=f)


def test_tight_radius_culls_sub_cutoff_opacity():
    """opacity <= 1/255 can never pass the blend cutoff: fully culled."""
    params, cam = _regrow_setup(20, 3)
    params = dataclasses.replace(params, opacities=torch.full_like(params.opacities, -8.0))
    pg = preprocess(params, cam, RenderConfig(sh_degree=1, tight_radius=True))
    assert int(pg.ntiles.sum()) == 0


@pytest.fixture(scope="module")
def small_setup():
    params = random_scene(60, seed=4, sh_degree=1, scale_range=(0.05, 0.3), device="cpu")
    cam = look_at_camera([0, 0, 6.0], [0, 0, 0], 64, 64, fov_deg=60.0, device="cpu")
    cfg = RenderConfig(sh_degree=1, max_per_tile=128, tile_chunk=8, gauss_chunk=16)
    target = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 1, (64, 64, 3)).astype(np.float32))
    return params, cam, cfg, target


@pytest.mark.parametrize("field", ["means", "opacities", "sh"])
def test_grads_match_finite_difference(small_setup, field):
    """Central differences on the 12 coordinates of largest gradient; some
    may cross a discrete event (tile membership, cutoffs, order), so 9 of
    the 12 must agree within 15%."""
    params, cam, cfg, target = small_setup

    def loss(p):
        with torch.no_grad():
            img, _ = render_stages(p, cam, cfg)
        return float(torch.mean((img - target) ** 2))

    _, _, grads = _grads(params, cam, cfg, target)
    gflat = grads[field].double().reshape(-1).numpy()
    base = getattr(params, field)
    eps, ok = 2e-4, 0
    for ci in np.argsort(-np.abs(gflat))[:12]:
        d = torch.zeros(base.numel(), dtype=torch.float64)
        d[ci] = eps
        flat = base.double().reshape(-1)
        plus = (flat + d).float().reshape(base.shape)
        minus = (flat - d).float().reshape(base.shape)
        fd = (loss(dataclasses.replace(params, **{field: plus}))
              - loss(dataclasses.replace(params, **{field: minus}))) / (2 * eps)
        an = gflat[ci]
        if abs(fd - an) / max(abs(fd), abs(an), 1e-8) < 0.15:
            ok += 1
    assert ok >= 9, f"{field}: only {ok}/12 finite-difference coordinates matched"
