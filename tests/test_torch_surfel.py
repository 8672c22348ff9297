"""2D Gaussian surfels (2D Gaussian Splatting) on the port's plain path: the
pipeline against the plain reference (``tpusplat_torch/surfel_reference.py``)
map by map and leaf by leaf through the full loss, the one-pass distortion
against the literal double sum, a fronto-parallel disk against the closed
form of its screen Gaussian, the screen box against every pixel a surfel
reaches, a compiled surfel step against the eager one, the step's stamp
order, the 18-row segment reduce, and the trainer's and densify's routes."""

import math

import numpy as np
import pytest
import torch

from tpusplat_torch import surfel_reference as ref
from tpusplat_torch import trace
from tpusplat_torch.camera import look_at_camera
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.ops import segment_reduce as sr
from tpusplat_torch.ops import surfel
from tpusplat_torch.render import render_stages
from tpusplat_torch.train import step as tstep
from tpusplat_torch.train import losses
from tpusplat_torch.types import SurfelParams

MAPS = ("rgb", "alpha", "depth_sum", "normal", "distortion")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(n=600, seed=3, scale_range=(0.05, 0.4), extent=2.0):
    g = random_scene(n, seed=seed, sh_degree=3, scale_range=scale_range, extent=extent,
                     device="cpu")
    return SurfelParams.from_gaussians(g)


def _camera(w=64, h=48, eye=(0.3, 0.5, 5.0)):
    return look_at_camera(list(eye), [0.0, 0.0, 0.0], w, h, fov_deg=60.0, device="cpu")


def _cfg():
    return RenderConfig(sh_degree=3, capacity_mult=64, max_per_tile=4096)


def _ref_camera(cam):
    return dict(view=cam.view, cam_pos=cam.cam_pos, tan_fovx=float(cam.tan_fovx),
                tan_fovy=float(cam.tan_fovy), width=cam.width, height=cam.height)


def _ref_params(params):
    return {k: getattr(params, k) for k in (*ref.FIELDS, "alive")}


def test_maps_match_the_reference():
    """Every map of the port's render against the reference's, every surfel
    against every pixel; each within 2e-5 of its largest magnitude (the
    depth sum, through the ray-plane intersection's cross products, within
    4e-4); the distortion within 3e-7: the one-pass form cancels terms of
    order w m^2 <= 1 (m lies near 1), so float32 leaves a few 1e-8."""
    params, cam, cfg = _scene(), _camera(), _cfg()
    img, aux = render_stages(params, cam, cfg)
    assert int(aux["capacity_overflow"]) == 0 and int(aux["num_instances"]) > 1000
    want = ref.render(ref.project(_ref_params(params), _ref_camera(cam)), _ref_camera(cam))
    got = dict(aux, rgb=img)
    for k in MAPS:
        scale = float(want[k].abs().max())
        tol = dict(depth_sum=4e-4 * scale, distortion=3e-7).get(k, 2e-5 * scale)
        assert float((got[k] - want[k]).abs().max()) <= tol, k
    assert float((aux["transmittance"] - want["tmap"]).abs().max()) <= 2e-5
    assert float(want["distortion"].max()) > 0 and float(want["alpha"].max()) > 0.9


def test_every_leaf_gradient_matches_the_reference():
    """The loss (photometric, distortion, normal consistency) and the
    gradient of every leaf against autograd of the reference: the loss
    within 1e-5, each leaf's gradient within 1e-3 of its norm (the
    regularizers' gradients pass through differences of the expected
    depth, where float32 rounding orders differ by some 1e-4)."""
    params, cam, cfg = _scene(), _camera(), _cfg()
    g = torch.Generator().manual_seed(5)
    target = torch.rand((cam.height, cam.width, 3), generator=g)
    loss, aux, leaves = tstep.step_forward(tstep.create_train_state(params), cam, target, cfg)
    grads = tstep.step_backward(loss, leaves)
    want_loss, want = ref.loss_and_grads(_ref_params(params), _ref_camera(cam), target)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    for k in ref.FIELDS:
        assert grads[k].shape == want[k].shape
        assert float(want[k].norm()) > 0, k
        assert float((grads[k] - want[k]).norm() / want[k].norm()) < 1e-3, k


@pytest.mark.parametrize("weights", [(0.0, 0.05), (100.0, 0.0)])
def test_each_regularizer_reaches_the_leaves(weights, monkeypatch):
    """With one regularizer at a time, the step's loss and the means'
    gradient against the reference's."""
    monkeypatch.setattr(losses, "LAMBDA_DIST", weights[0])
    monkeypatch.setattr(losses, "LAMBDA_NORMAL", weights[1])
    params, cam, cfg = _scene(n=300, seed=4), _camera(48, 32), _cfg()
    target = torch.full((cam.height, cam.width, 3), 0.5)
    st = tstep.create_train_state(params)
    loss, _, leaves = tstep.step_forward(st, cam, target, cfg, 0.2)
    grads = tstep.step_backward(loss, leaves)
    want_loss, want = ref.loss_and_grads(_ref_params(params), _ref_camera(cam), target, 0.2,
                                         *weights)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    assert float((grads["means"] - want["means"]).norm() / want["means"].norm()) < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_one_pass_distortion_is_the_double_sum(seed):
    """The one-pass distortion against the literal sum over pairs,
    sum_i w_i sum_{j<i} w_j (m_i - m_j)^2: the reference's in float64 to
    1e-10 of the largest (the algebra), the port's in float32 to 3e-7 (the
    expanded form cancels terms of order w m^2 <= 1: m lies near 1)."""
    params, cam = _scene(n=200, seed=seed, scale_range=(0.1, 0.5)), _camera(32, 24)
    rcam = _ref_camera(cam)
    p64 = {k: v.double() if v.is_floating_point() else v for k, v in _ref_params(params).items()}
    pr = ref.project(p64, dict(rcam, view=cam.view.double(), cam_pos=cam.cam_pos.double()))
    double = ref.render(pr, rcam, distortion="double_sum")["distortion"]
    one = ref.render(pr, rcam)["distortion"]
    _, aux = render_stages(params, cam, _cfg())
    scale = float(double.max())
    assert scale > 5e-5
    assert float((one - double).abs().max()) <= 1e-10 * scale
    assert float((aux["distortion"].double() - double).abs().max()) <= 3e-7


def _disk(means, quat, scales, opacity):
    n = 1
    return SurfelParams(means=torch.tensor([means], dtype=torch.float32),
                        log_scales=torch.log(torch.tensor([scales], dtype=torch.float32)),
                        quats=torch.tensor([quat], dtype=torch.float32),
                        opacities=torch.tensor([math.log(opacity / (1 - opacity))]),
                        sh=torch.zeros((n, 16, 3)), alive=torch.ones(n, dtype=torch.bool))


def test_fronto_parallel_disk_is_its_screen_gaussian():
    """A disk facing the camera at depth z0 renders op exp(-((x - cx)^2 /
    sx^2 + (y - cy)^2 / sy^2) / 2) with sx = f_x s_u / z0, sy = f_y s_v / z0
    about the image of its centre (both sigmas over a pixel, so the
    low-pass filter never wins), its depth z0 and its normal facing the
    camera."""
    w, h, z0, op = 96, 64, 5.0, 0.8
    cam = look_at_camera([0.0, 0.0, z0], [0.0, 0.0, 0.0], w, h, fov_deg=60.0, device="cpu")
    params = _disk([0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [0.15, 0.08], op)
    _, aux = render_stages(params, cam, _cfg())
    fx, fy, cx, cy = (float(v) for v in surfel.intrinsics(cam))
    sx, sy = fx * 0.15 / z0, fy * 0.08 / z0
    assert min(sx, sy) > 1.0
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64), indexing="ij")
    alpha = op * torch.exp(-0.5 * ((xs - cx) ** 2 / sx ** 2 + (ys - cy) ** 2 / sy ** 2))
    alpha = torch.where(alpha >= 1 / 255, torch.clamp_max(alpha, 0.99), 0.0).float()
    assert float((aux["alpha"] - alpha).abs().max()) < 2e-6
    on = alpha > 0
    assert float((aux["depth_sum"][on] / aux["alpha"][on] - z0).abs().max()) < 1e-5
    assert torch.allclose(aux["normal"][on] / aux["alpha"][on, None],
                          torch.tensor([0.0, 0.0, -1.0]), atol=1e-6)


def _edge_on_disk(cos, cam, pixel=(40.0, 30.0), depth=5.0, twist=0.4):
    """A disk centred on the ray of ``pixel``, its normal at ``cos`` to that
    ray: the ray meets the disk's plane at its centre, u = v = 0, however
    nearly edge-on it is seen."""
    fx, fy, cx, cy = (float(v) for v in surfel.intrinsics(cam))
    r = torch.tensor([(pixel[0] - cx) / fx, (pixel[1] - cy) / fy, 1.0], dtype=torch.float64)
    rot, t = cam.view[:3, :3].double(), cam.view[:3, 3].double()
    means = rot.T @ (depth * r - t)
    ray = rot.T @ (r / r.norm())
    side = torch.linalg.cross(ray, torch.tensor([0.3, 1.0, 0.2], dtype=torch.float64))
    side = side / side.norm()
    nrm = cos * ray + math.sqrt(1 - cos * cos) * side
    axis = torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64), nrm)
    half = 0.5 * math.atan2(float(axis.norm()), float(nrm[2]))
    w, x, y, z = math.cos(half), *(math.sin(half) * axis / axis.norm()).tolist()
    c, s = math.cos(twist), math.sin(twist)  # then a turn about the normal
    params = _disk(means.tolist(), [w * c - z * s, x * c + y * s, y * c - x * s, w * s + z * c],
                   [0.3, 0.2], 0.8)
    params.sh = 0.3 * torch.randn((1, 16, 3), generator=torch.Generator().manual_seed(2))
    return params


@pytest.mark.parametrize("twist", [0.4, 1.9])
@pytest.mark.parametrize("cos", [1e-4, 3e-4, 1e-3])
def test_grazing_ray_takes_the_filter(cos, twist):
    """A disk seen within a tenth of a degree of edge-on, whose centre lies
    on a pixel's ray, its axes turned two ways about its normal: there k
    and l are mostly cancellation, and the disk's term and its gradients
    are rounding noise (the float32 gradients without the grazing test read
    5e-3 to 0.5 apart from float64's). With the filter's term at grazing
    pairs, the port's float32 loss and every leaf's gradient lie within
    1e-4 of the reference's in float64."""
    cam = _camera()
    params = _edge_on_disk(cos, cam, twist=twist)
    a = surfel.preprocess2d_plain(params, cam, _cfg()).table[..., None]
    px, py = torch.tensor([[40.0]]), torch.tensor([[30.0]])
    rays = surfel.pixel_rays(px, py, surfel.ray_intrinsics(cam))
    _, _, rho3, rho2, _, ok = surfel.pair_terms(a, px, py, rays, 0.2)
    assert bool(ok.all()) and bool(torch.isinf(rho3).all()) and float(rho2.max()) < 1.0
    target = torch.rand((cam.height, cam.width, 3), generator=torch.Generator().manual_seed(5))
    loss, _, leaves = tstep.step_forward(tstep.create_train_state(params), cam, target, _cfg())
    grads = tstep.step_backward(loss, leaves)
    p64 = {k: v.double() if v.is_floating_point() else v for k, v in _ref_params(params).items()}
    rcam = dict(_ref_camera(cam), view=cam.view.double(), cam_pos=cam.cam_pos.double())
    want_loss, want = ref.loss_and_grads(p64, rcam, target.double())
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    for k in ("means", "log_scales", "quats", "opacities"):
        assert float(want[k].norm()) > 0, k
        assert float((grads[k].double() - want[k]).norm() / want[k].norm()) < 1e-4, k


def test_screen_box_holds_every_pixel_a_surfel_reaches():
    """Brute force over random disks (any tilt, opacities from 0.02 to
    0.99, some across the frame's edge): every pixel at which a surfel's
    alpha reaches 1/255 lies in its pixel box (within 1e-3 px) and in the
    tiles of its tile box."""
    w, h = 80, 60
    cam = _camera(w, h, eye=(0.0, 0.3, 4.0))
    cfg = _cfg()
    params = _scene(n=400, seed=7, scale_range=(0.02, 0.6), extent=1.5)
    g = torch.Generator().manual_seed(9)
    op = 0.02 + 0.97 * torch.rand(params.num_gaussians, generator=g)
    params.opacities = torch.log(op / (1 - op))
    ps = surfel.preprocess2d_plain(params, cam, cfg)
    box, _ = surfel.pixel_box(ps.table, cfg.alpha_min)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    px, py = xs.reshape(1, -1), ys.reshape(1, -1)
    vis = ps.ntiles > 0
    a = ps.table[:, vis][..., None]
    rays = surfel.pixel_rays(px, py, surfel.ray_intrinsics(cam))
    _, _, rho3, rho2, _, ok = surfel.pair_terms(a, px, py, rays, cfg.z_near_cull)
    alpha = torch.clamp_max(a[surfel.S_OP] * torch.exp(-0.5 * torch.minimum(rho3, rho2)), 0.99)
    reach = ok & (alpha >= cfg.alpha_min)
    assert int(reach.any(1).sum()) > 100
    b = box[vis]
    inside = ((px >= b[:, :1] - 1e-3) & (px <= b[:, 1:2] + 1e-3)
              & (py >= b[:, 2:3] - 1e-3) & (py <= b[:, 3:4] + 1e-3))
    assert not bool((reach & ~inside).any())
    aabb = ps.aabb[vis].long()
    tx, ty = (px // cfg.tile_w).long(), (py // cfg.tile_h).long()
    in_tiles = (tx >= aabb[:, :1]) & (tx < aabb[:, 2:3]) & (ty >= aabb[:, 1:2]) & (ty < aabb[:, 3:4])
    assert not bool((reach & ~in_tiles).any())


def test_compiled_surfel_step_equals_the_eager_one():
    """Three compiled steps (capture, replays, the state donated) against
    three eager steps from one state: losses and every leaf of the state bit
    for bit on one thread."""
    params, cfg = _scene(n=300, seed=2), _cfg()
    cams = [_camera(48, 32, eye=(x, 0.5, 5.0)) for x in (0.0, 0.7, -0.7)]
    g = torch.Generator().manual_seed(1)
    targets = [torch.rand((32, 48, 3), generator=g) for _ in cams]
    opt = tstep.make_optimizer(scene_extent=2.0)
    step = tstep.compile_train_step()
    eager = tstep.create_train_state(params)
    comp = tstep.create_train_state(params)
    for cam, target in zip(cams, targets):
        eager, me = tstep.train_step(eager, cam, target, cfg, opt)
        comp, mc = step(comp, cam, target, cfg, opt)
        assert torch.equal(me["loss"], mc["loss"])
    assert isinstance(comp.params, SurfelParams) and comp.params.log_scales.shape == (300, 2)
    for k in tstep.TRAINABLE:
        assert torch.equal(getattr(comp.params, k), getattr(eager.params, k)), k
        assert torch.equal(comp.mu[k], eager.mu[k]) and torch.equal(comp.nu[k], eager.nu[k])
    assert step.stats["captures"] == 1 and int(comp.step) == 3


def test_surfel_step_stamps_its_regularizers(monkeypatch):
    """A compiled surfel step's stamps: the regularizers' forward after the
    photometric loss's, their backward first, the photometric backward
    stamped ``loss`` again, then the blends' gradient."""
    monkeypatch.setattr(trace, "_host", trace._HostRings())
    params, cfg, cam = _scene(n=200, seed=6), _cfg(), _camera(48, 32)
    step = tstep.compile_train_step()
    state = tstep.create_train_state(params)
    target = torch.full((32, 48, 3), 0.4)
    for _ in range(2):
        state, _ = step(state, cam, target, cfg, tstep.make_optimizer())
    units = trace.read("cpu").units(step.tag)
    assert [[name for name, _ in u.marks] for u in units] == [[
        "preprocess", "binning", "blend", "loss", "regularize", "regularize_bwd", "loss",
        "blend_bwd", "preprocess_bwd", "adam", "writeback", "end"]] * 2
    assert set(units[0].stage_ms()) >= {"loss", "regularize", "regularize_bwd"}


def test_segment_reduce_takes_eighteen_rows():
    """The dense segment reduce sums 18 rows as it sums 9: each row
    ``index_add_``'s, and the first nine bit for bit those of a 9-row call,
    the sentinel ids dropped."""
    g = torch.Generator().manual_seed(3)
    n, r = 500, 2000
    gid = torch.sort(torch.randint(0, n + 1, (r,), generator=g, dtype=torch.int32)).values
    bounds = torch.searchsorted(gid, torch.arange(n + 1, dtype=torch.int32), out_int32=True)
    rows = torch.randn((18, r), generator=g)
    rows[:, gid == n] = float("nan")
    out = sr.segment_reduce(rows, gid, bounds)
    keep = gid < n
    want = torch.zeros((18, n)).index_add_(1, gid[keep].long(), rows[:, keep])
    assert out.shape == (18, n) and torch.allclose(out, want, atol=1e-5)
    assert torch.equal(sr.segment_reduce(rows[:9].contiguous(), gid, bounds), out[:9])
    assert sr.DENSE_ROWS == (9, 18)


def test_densify_refuses_a_surfel_scene():
    from tpusplat_torch.train import densify, prng

    state = tstep.create_train_state(_scene(n=50))
    with pytest.raises(TypeError, match="surfel"):
        densify.densify_and_prune(state, prng.key(0), densify.DensifyConfig(), 1.0)


def test_trainer_trains_surfels(tmp_path):
    """``trainer --surfels`` trains through the single-card loop, writes the
    2D Gaussian Splatting PLY (two scales), and refuses densification."""
    from tpusplat_torch import trainer

    out = tmp_path / "s.ply"
    summary = trainer.main(["--synthetic", "--surfels", "--steps", "4", "--n-init", "300",
                            "--width", "48", "--height", "32", "--densify-every", "0",
                            "--log-every", "2", "--device", "cpu", "--out", str(out)])
    assert isinstance(summary["state"].params, SurfelParams) and summary["step"] >= 4
    assert summary["compiled"]["captures"] == 1
    header = out.read_bytes().split(b"end_header\n")[0].decode()
    assert "scale_1" in header and "scale_2" not in header
    body = out.read_bytes().split(b"end_header\n")[1]
    assert len(body) == 300 * 61 * 4
    assert np.isfinite(np.frombuffer(body, "<f4")).all()
    with pytest.raises(SystemExit):
        trainer.main(["--synthetic", "--surfels", "--steps", "2", "--device", "cpu"])


def test_session_draws_a_surfel_scene():
    """``Session.draw`` renders a surfel scene through ``render_auto`` and the
    session's compiled render, with no change to its call; the frame equals
    an eager ``render_stages`` of the same camera."""
    from tpusplat_torch.session import Session, SessionConfig

    params = _scene(n=300, seed=8)
    s = Session(SessionConfig(width=48, height=32, fov=60.0, render=_cfg()), params=params,
                device="cpu")
    s.initialize()
    s.position = np.array([0.2, 0.3, 5.0])
    img, aux = s.draw()
    img2, _ = s.draw()
    want, want_aux = render_stages(params, s.camera(), s.config.render)
    assert img.shape == (32, 48, 3) and float(img.max()) > 0
    assert torch.equal(img, want) and torch.equal(img2, want)
    assert torch.equal(aux["depth_sum"], want_aux["depth_sum"])
    assert s._render.stats["captures"] == 1
