"""The route of tpusplat_torch.ops.preprocess.preprocess and the guard of
its kernel's wrapper. A call off the CPU that autograd records for the
parameters takes the kernels' autograd Function, one where a camera tensor
requires grad the plain version with its graph, every other call off the
CPU the forward kernel alone (the kernels' C calls replaced here by
stubs, and the forward's wrapper by one that records its calls: there is
no card, so meta tensors stand in for CUDA ones); a CPU call takes the
plain version. The wrapper refuses
what the kernel does not take with ValueError."""

import pathlib
import re

import pytest
import torch

from tpusplat_torch import config
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops import preprocess as pre
from tpusplat_torch.types import Camera, GaussianParams

N = 32
CFG = RenderConfig(sh_degree=3, tight_radius=True)


def _inputs(device="cpu", **replace):
    g = torch.Generator().manual_seed(0)
    means = torch.randn(N, 3, generator=g) + torch.tensor([0.0, 0.0, 4.0])
    t = dict(means=means, log_scales=torch.randn(N, 3, generator=g) - 3.0,
             quats=torch.randn(N, 4, generator=g), opacities=torch.randn(N, generator=g),
             sh=torch.randn(N, 16, 3, generator=g), alive=torch.ones(N, dtype=torch.bool),
             view=torch.eye(4), proj=torch.eye(4), cam_pos=torch.zeros(3),
             tan_fovx=torch.tensor(0.5), tan_fovy=torch.tensor(0.3))
    t.update(replace)
    t = {k: v.to(device) for k, v in t.items()}
    params = GaussianParams(**{k: t[k] for k in pre.PARAM_SHAPES})
    cam = Camera(**{k: t[k] for k in pre.CAMERA_SHAPES}, width=64, height=48)
    return params, cam


@pytest.fixture
def kernel_calls(monkeypatch):
    calls, preprocess_cuda = [], pre.preprocess_cuda

    def recorded(params, camera, cfg):
        calls.append((params, camera, cfg))
        return preprocess_cuda(params, camera, cfg)

    def launch(params, camera, cfg, out):
        pre.LAUNCHES += 1

    def launch_backward(params, camera, cfg, d_table, grads):
        pre.BACKWARD_LAUNCHES += 1

    monkeypatch.setattr(pre, "preprocess_cuda", recorded)
    monkeypatch.setattr(pre, "check_inputs", lambda params, camera: None)
    monkeypatch.setattr(pre, "launch", launch)
    monkeypatch.setattr(pre, "launch_backward", launch_backward)
    return calls


# (device, gradients enabled, the leaf that requires grad, the route)
ROUTES = [
    ("meta", False, None, "kernel"),
    ("meta", True, None, "kernel"),
    ("meta", False, "means", "kernel"),  # under no_grad nothing is recorded
    ("meta", True, "means", "function"),
    ("meta", True, "sh", "function"),
    ("meta", True, "view", "plain"),  # the kernels write no camera gradient
    ("cpu", False, None, "plain"),
    ("cpu", True, None, "plain"),
    ("cpu", True, "log_scales", "plain"),
]


@pytest.mark.parametrize("device,grad,leaf,route", ROUTES)
def test_route_follows_what_autograd_records(kernel_calls, device, grad, leaf, route):
    params, cam = _inputs(device)
    if leaf is not None:
        obj = params if leaf in pre.PARAM_SHAPES else cam
        setattr(obj, leaf, getattr(obj, leaf).detach().requires_grad_(True))
    launches, backward = pre.LAUNCHES, pre.BACKWARD_LAUNCHES
    with torch.set_grad_enabled(grad):
        pg = pre.preprocess(params, cam, CFG)
    assert isinstance(pg, pre.ProcessedGaussians)
    if route in ("kernel", "function"):  # one forward launch, the table as it lies
        assert pre.LAUNCHES == launches + 1 and pre.BACKWARD_LAUNCHES == backward
        assert len(kernel_calls) == 1
        assert kernel_calls[0][0] is params and kernel_calls[0][1] is cam
        assert pre.attribute_table(pg) is pg.table
    if route == "kernel":
        assert pg.table.grad_fn is None
        return
    if route == "function":  # and one backward launch
        assert pg.table.grad_fn.name() == "_PreprocessBackward"
        (pg.color.sum() + pg.conic.sum() + pg.uv.sum() + pg.opacity.sum()).backward()
        assert pre.BACKWARD_LAUNCHES == backward + 1
        t = getattr(params, leaf)
        assert t.grad is not None and t.grad.shape == t.shape
        return
    assert not kernel_calls and pre.LAUNCHES == launches
    assert pg.ntiles.dtype == torch.int32 and pg.aabb.shape == (N, 4)
    recorded = grad and leaf is not None
    graphs = [getattr(pg, f).grad_fn for f in ("uv", "conic", "opacity", "color", "radius")]
    assert any(g is not None for g in graphs) == recorded
    if recorded and device == "cpu":  # the graph reaches the leaf
        (pg.color.sum() + pg.conic.sum() + pg.uv.sum()).backward()
        assert torch.isfinite(params.log_scales.grad).all()
        assert params.log_scales.grad.abs().sum() > 0


def _misaligned(shape):
    flat = torch.zeros(int(torch.tensor(shape).prod()) + 1)
    return flat[1:].view(shape)


# (what is wrong, the replaced input, the message)
REFUSED = [
    ("float64 means", dict(means=torch.zeros(N, 3, dtype=torch.float64)), "means must be"),
    ("float16 sh", dict(sh=torch.zeros(N, 16, 3, dtype=torch.float16)), "sh must be"),
    ("uint8 alive", dict(alive=torch.ones(N, dtype=torch.uint8)), "alive must be"),
    ("non-contiguous means", dict(means=torch.zeros(3, N).t()), "not contiguous"),
    ("non-contiguous view", dict(view=torch.eye(4).t()), "not contiguous"),
    ("sh [N, 48]", dict(sh=torch.zeros(N, 48)), "sh must be"),
    ("quats [N, 3]", dict(quats=torch.zeros(N, 3)), "quats must be"),
    ("opacities [N, 1]", dict(opacities=torch.zeros(N, 1)), "opacities must be"),
    ("alive [N - 1]", dict(alive=torch.ones(N - 1, dtype=torch.bool)), "alive must be"),
    ("view [3, 4]", dict(view=torch.eye(4)[:3].contiguous()), "view must be"),
    ("cam_pos [4]", dict(cam_pos=torch.zeros(4)), "cam_pos must be"),
    ("tan_fovx [1]", dict(tan_fovx=torch.ones(1)), "tan_fovx must be"),
    ("misaligned sh", dict(sh=_misaligned((N, 16, 3))), "sh must be 16-byte aligned"),
    ("misaligned quats", dict(quats=_misaligned((N, 4))), "quats must be 16-byte aligned"),
    ("CPU tensors", {}, "no kernel for tensors on cpu"),
]


@pytest.mark.parametrize("what,replace,message", REFUSED, ids=[r[0] for r in REFUSED])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(what, replace, message):
    params, cam = _inputs("cpu", **replace)
    launches = pre.LAUNCHES
    with pytest.raises(ValueError, match=re.escape(message)):
        pre.preprocess_cuda(params, cam, CFG)
    assert pre.LAUNCHES == launches


def test_output_fields_cover_the_buffer_once():
    """The kernel writes 16 words a Gaussian, field by field: aabb, the
    [9, N] table (uv, conic, opacity, color as rows), depth, radius,
    ntiles. The wrapper's views must cover each word once, in that order."""
    out = torch.arange(16 * N, dtype=torch.int32).view(torch.float32)
    pg = pre.output_fields(out, N)
    words = {"aabb": (0, 4), "uv": (4, 2), "conic": (6, 3), "opacity": (9, 1),
             "color": (10, 3), "depth": (13, 1), "radius": (14, 1), "ntiles": (15, 1)}
    seen = torch.zeros(16 * N, dtype=torch.int64)
    for name, (first, width) in words.items():
        f = getattr(pg, name)
        assert f.shape[0] == N and f.numel() == width * N, name
        assert f.dtype == (torch.int32 if name in ("aabb", "ntiles") else torch.float32)
        idx = f.contiguous().view(torch.int32).long()
        rows = idx.reshape(N, width).T  # a row a component: word first * N + c * N + g
        want = (first + torch.arange(width)[:, None]) * N + torch.arange(N)[None, :]
        if name == "aabb":  # [N, 4] row-major
            want = torch.arange(4 * N).view(N, 4).T
        assert torch.equal(rows, want), name
        seen[idx.reshape(-1)] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("source", ["kernel layout", "plain"])
def test_attribute_table(source):
    """pack_instances' [9, N] table: the kernel's fields are views of it, so
    it is returned as it lies (no copy); the plain version's fields are
    concatenated; the rows are the same either way."""
    params, cam = _inputs("cpu")
    plain = pre.preprocess_plain(params, cam, CFG)
    want = torch.cat([plain.uv.T, plain.conic.T, plain.opacity[None, :], plain.color.T])
    if source == "plain":
        pg = plain
    else:
        out = torch.zeros(pre.OUT_WORDS * N)
        pg = pre.output_fields(out, N)
        for f in ("uv", "conic", "opacity", "color"):
            getattr(pg, f).copy_(getattr(plain, f))
    table = pre.attribute_table(pg)
    assert table.shape == (9, N) and table.is_contiguous()
    assert torch.equal(table, want)
    assert (table.data_ptr() == pg.uv.data_ptr()) == (source == "kernel layout")


def test_kernel_constants_are_the_configs():
    """csrc/preprocess.cu holds config.py's SH constants as literals."""
    src = (pathlib.Path(pre.__file__).parents[1] / "csrc" / "preprocess.cu").read_text()
    got = {m[0]: float(m[1]) for m in
           re.findall(r"constexpr float (kC\d+) = static_cast<float>\(([-0-9.e]+)\)", src)}
    want = {"kC0": config.SH_C0, "kC1": config.SH_C1,
            **{f"kC2{i}": c for i, c in enumerate(config.SH_C2)},
            **{f"kC3{i}": c for i, c in enumerate(config.SH_C3)}}
    assert got == want
