"""preprocess_backward_plain, the backward kernel's arithmetic in plain
PyTorch, against autograd of preprocess_plain on the CPU; and the autograd
Function that puts the two kernels in a train step, with its C calls
emulated by the plain versions.

The scene holds ordinary Gaussians and groups that each meet one edge of
the backward: tx/tz and ty/tz exactly at +-1.3 tan_fov and one float past
it, depth exactly at z_near_cull and one float under and over it, det <= 0
(degenerate and needle-thin covariances), a red channel exactly at 0 and one
float below it, behind the camera, a zero quaternion, dead slots, and
Gaussians whose table gradient is zero."""

import dataclasses

import numpy as np
import pytest
import torch

from tpusplat_torch.config import SH_C0, RenderConfig
from tpusplat_torch.ops import preprocess as pre
from tpusplat_torch.ops.rasterize import pack_instances
from tpusplat_torch.types import Camera, GaussianParams

torch.set_num_threads(2)

W, H, TAN_FOVX = 96, 64, 0.6
TAN_FOVY = TAN_FOVX * H / W
RTOL = 1e-6


def _next(x, toward):
    return np.nextafter(np.float32(x), np.float32(toward), dtype=np.float32)


def _scene(seed=0, n_ordinary=1200):
    """(params, camera, groups): an identity view, so a Gaussian's view
    coordinates are its mean exactly; ``groups`` name index ranges."""
    rng = np.random.default_rng(seed)
    lim_x = np.float32(np.float32(1.3) * np.float32(TAN_FOVX))
    lim_y = np.float32(np.float32(1.3) * np.float32(TAN_FOVY))
    groups, means, scales = {}, [], []

    def add(name, xyz, s=None):
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        lo = sum(len(m) for m in means)
        means.append(xyz)
        scales.append(rng.uniform(0.01, 0.3, xyz.shape).astype(np.float32) if s is None
                      else np.broadcast_to(np.asarray(s, np.float32), xyz.shape))
        groups[name] = (lo, lo + len(xyz))

    # tz = 2, so tx / tz is tx halved exactly: at the limit and one float past
    clamp = []
    for lim, axis in ((lim_x, 0), (lim_y, 1)):
        for t in (2 * lim, -2 * lim, _next(2 * lim, np.inf), _next(-2 * lim, -np.inf)):
            p = [0.1, 0.1, 2.0]
            p[axis] = t
            clamp.append(p)
    add("clamp", clamp)
    z_near = np.float32(0.2)
    add("depth", [[0.01, 0.02, z] for z in (z_near, _next(z_near, 0), _next(z_near, 1))])
    # Sigma underflows to 0: det = 0 at dilation 0, else the dilation's square
    add("det_zero", [[0.1, -0.1, 3.0], [-0.2, 0.1, 4.0]], s=np.exp(np.float32(-60.0)))
    # needle-thin: one axis 1000 long, two 1e-5; the 2D covariance cancels
    z = rng.uniform(2.0, 20.0, 64)
    add("needle", np.stack([rng.uniform(-0.5, 0.5, 64) * TAN_FOVX * z,
                            rng.uniform(-0.5, 0.5, 64) * TAN_FOVY * z, z], -1),
        s=[1000.0, 1e-5, 1e-5])
    add("red", [[0.3, -0.2, 3.0], [-0.3, 0.2, 3.5]])
    add("behind", [[0.2, 0.3, -2.0], [0.0, 0.0, 0.0]])
    z = rng.uniform(1.0, 10.0, n_ordinary)
    add("ordinary", np.stack([rng.uniform(-1.2, 1.2, n_ordinary) * TAN_FOVX * z,
                              rng.uniform(-1.2, 1.2, n_ordinary) * TAN_FOVY * z, z], -1))
    mean = np.concatenate(means)
    n = len(mean)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats[groups["behind"][0]] = 0.0  # the 1e-12 guard alone
    sh = rng.uniform(-1.0, 1.0, (n, 16, 3)).astype(np.float32)
    lo, _ = groups["red"]
    # red DC with C0 * dc == -0.5 exactly (so c = 0), and the next float down (c < 0)
    dc = np.float32(-0.5) / np.float32(SH_C0)
    sh[lo:lo + 2, :, 0] = 0.0
    sh[lo, 0, 0], sh[lo + 1, 0, 0] = dc, _next(dc, -np.inf)
    alive = np.ones(n, bool)
    alive[rng.random(n) < 0.1] = False
    params = GaussianParams.create(
        means=mean, log_scales=np.log(np.concatenate(scales)), quats=quats,
        opacities=rng.normal(size=n).astype(np.float32), sh=sh, alive=alive, device="cpu")
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1], proj[2, 2], proj[3, 2] = 1 / TAN_FOVX, 1 / TAN_FOVY, 1.0, 1.0
    cam = Camera.from_matrices(np.eye(4), proj, [0.3, -0.4, -1.0], TAN_FOVX, TAN_FOVY, W, H,
                               device="cpu")
    return params, cam, groups


def _table_grad(n, seed):
    """A seeded [9, N] cotangent whose every 7th Gaussian gets zero."""
    g = torch.randn(9, n, generator=torch.Generator().manual_seed(seed))
    g[:, ::7] = 0.0
    return g


def _autograd(params, cam, cfg, d_table):
    leaves = {k: getattr(params, k).detach().clone().requires_grad_(True)
              for k in pre.GRAD_FIELDS}
    table = pre.attribute_table(pre.preprocess_plain(
        dataclasses.replace(params, **leaves), cam, cfg))
    grads = torch.autograd.grad(table, list(leaves.values()), d_table)
    return dict(zip(pre.GRAD_FIELDS, grads))


def _assert_close(got, want):
    for k in pre.GRAD_FIELDS:
        assert got[k].shape == want[k].shape and torch.isfinite(got[k]).all(), k
        err = float((got[k] - want[k]).norm() / want[k].norm().clamp_min(1e-30))
        assert err <= RTOL, (k, err)


SCENE = _scene()


@pytest.mark.parametrize("modifier", [1.0, 0.6])
@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("clamp", ["red", "all", "none"])
@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_backward_plain_is_autograd_of_the_plain_forward(sh_degree, clamp, tight, modifier):
    params, cam, _ = SCENE
    cfg = RenderConfig(sh_degree=sh_degree, color_clamp=clamp, tight_radius=tight,
                       scale_modifier=modifier)
    d_table = _table_grad(params.num_gaussians, seed=sh_degree)
    got = pre.preprocess_backward_plain(params, cam, cfg, d_table)
    _assert_close(got, _autograd(params, cam, cfg, d_table))
    k = (sh_degree + 1) ** 2
    assert not got["sh"][:, k:].any()  # the coefficients the degree leaves unused
    assert not any(got[f][::7].any() for f in pre.GRAD_FIELDS)  # zero table gradient


@pytest.mark.parametrize("dilation", [0.3, 0.0])
def test_the_scene_meets_every_edge(dilation):
    """Each group of the scene sits on the edge it is named for, on both
    sides where it has two, so the masks above are exercised."""
    params, cam, groups = SCENE
    cfg = RenderConfig(sh_degree=3, dilation=dilation)
    t = pre._forward_terms(params, cam, cfg)
    lo, hi = groups["clamp"]
    ux, uy = t.ux[lo:hi], t.uy[lo:hi]
    assert bool((ux[:2].abs() == t.limx).all() and (uy[4:6].abs() == t.limy).all())
    assert bool((ux[2:4].abs() > t.limx).all() and (uy[6:8].abs() > t.limy).all())
    lo, hi = groups["depth"]
    assert t.depth[lo] == cfg.z_near_cull and t.in_front[lo:hi].tolist() == [False, False, True]
    det = t.det[slice(*groups["det_zero"])]
    assert bool((det <= 0).all()) if dilation == 0.0 else bool((det > 0).all())
    needle = t.det[slice(*groups["needle"])]
    assert bool((needle <= 0).any() and (needle > 0).any())
    lo, _ = groups["red"]
    assert t.color_raw[lo, 0] == 0.0 and t.color_raw[lo + 1, 0] < 0.0
    assert not t.in_front[slice(*groups["behind"])].any()
    assert not params.alive.all()
    d_table = _table_grad(params.num_gaussians, seed=5)
    _assert_close(pre.preprocess_backward_plain(params, cam, cfg, d_table),
                  _autograd(params, cam, cfg, d_table))


@pytest.fixture
def emulated_kernels(monkeypatch):
    """The kernels' C calls replaced by their plain versions, on the CPU:
    the forward's buffer filled from preprocess_plain, the backward's
    gradients from preprocess_backward_plain; each call counted."""
    calls = dict(forward=0, backward=0)

    def forward(params, camera, cfg, out):
        calls["forward"] += 1
        n = params.num_gaussians
        with torch.no_grad():
            pg = pre.preprocess_plain(params, camera, cfg)
        ints = out.view(torch.int32)
        ints[:4 * n] = pg.aabb.reshape(-1)
        out[4 * n:13 * n] = pre.attribute_table(pg).reshape(-1)
        out[13 * n:14 * n], out[14 * n:15 * n] = pg.depth, pg.radius
        ints[15 * n:] = pg.ntiles

    def backward(params, camera, cfg, d_table, grads):
        calls["backward"] += 1
        for k, v in pre.preprocess_backward_plain(params, camera, cfg, d_table).items():
            grads[k].copy_(v)

    monkeypatch.setattr(pre, "check_inputs", lambda params, camera: None)
    monkeypatch.setattr(pre, "launch", forward)
    monkeypatch.setattr(pre, "launch_backward", backward)
    return calls


def test_function_through_the_gather_matches_autograd(emulated_kernels):
    """preprocess_differentiable as the blend consumes it: pack_instances
    gathers from the Function's table as it lies (no cat, no as_strided),
    and the five parameters' gradients equal autograd of the plain route
    through the same gather; one forward and one backward call."""
    from tpusplat_torch.ops.binning import bin_and_sort

    params, cam, _ = SCENE
    cfg = RenderConfig(sh_degree=3, tight_radius=True)
    with torch.no_grad():
        binned = bin_and_sort(pre.preprocess_plain(params, cam, cfg), W, H, cfg)
    cot = torch.randn(9, binned.gauss_id.shape[0], generator=torch.Generator().manual_seed(2))
    grads = {}
    for route in ("function", "plain"):
        leaves = {k: getattr(params, k).detach().clone().requires_grad_(True)
                  for k in pre.GRAD_FIELDS}
        p = dataclasses.replace(params, **leaves)
        pg = (pre.preprocess_differentiable if route == "function" else pre.preprocess_plain)(
            p, cam, cfg)
        if route == "function":
            assert pre.attribute_table(pg) is pg.table
            assert pg.table.grad_fn.name() == "_PreprocessBackward"
            assert not any(f.requires_grad for f in (pg.depth, pg.radius, pg.aabb, pg.ntiles))
        attr = pack_instances(pg, binned)
        grads[route] = dict(zip(pre.GRAD_FIELDS, torch.autograd.grad(
            attr, list(leaves.values()), cot)))
    assert emulated_kernels == dict(forward=1, backward=1)
    for k in pre.GRAD_FIELDS:
        assert torch.equal(grads["function"][k], grads["plain"][k]), k


def test_backward_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """preprocess_backward_cuda raises ValueError on a d_table that is not
    a contiguous float32 [9, N] on the parameters' device (the rest as
    check_inputs refuses it), and launches nothing."""
    params, cam, _ = SCENE
    cfg = RenderConfig(sh_degree=3)
    n = params.num_gaussians
    monkeypatch.setattr(pre, "check_inputs", lambda params, camera: None)
    launches = pre.BACKWARD_LAUNCHES
    for bad in (torch.zeros(9, n, dtype=torch.float64), torch.zeros(8, n),
                torch.zeros(n, 9).T, torch.zeros(9, n + 1)):
        with pytest.raises(ValueError, match="d_table must be contiguous float32"):
            pre.preprocess_backward_cuda(params, cam, cfg, bad)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no kernel for tensors on cpu"):
        pre.preprocess_backward_cuda(params, cam, cfg, torch.zeros(9, n))
    assert pre.BACKWARD_LAUNCHES == launches
