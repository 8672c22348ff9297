"""The port's preprocess against tpusplat.ops.preprocess, field by field,
on the same numpy scene: SH degrees 0-3, tight radius on and off, and
gradients from autograd against jax.grad."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.ops.preprocess import preprocess as jax_preprocess
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.ops.preprocess import preprocess

torch.set_num_threads(2)

FLOAT_FIELDS = ("uv", "conic", "opacity", "color", "depth", "radius")


def _both(n, seed, sh_degree, eye, w=128, h=96, srange=(0.01, 0.3)):
    params = jax_random_scene(n, seed=seed, sh_degree=sh_degree, scale_range=srange)
    cam = jax_look_at(eye, [0.0, 0.0, 0.0], w, h, fov_deg=60.0)
    p, c = to_numpy(params), to_numpy(cam)
    tp = convert.params_from_numpy(p.means, p.log_scales, p.quats, p.opacities, p.sh,
                                   p.alive, device="cpu")
    tc = convert.camera_from_numpy(c.view, c.proj, c.cam_pos, c.tan_fovx, c.tan_fovy,
                                   c.width, c.height, device="cpu")
    return params, cam, tp, tc


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_preprocess_matches_jax(sh_degree, tight):
    # The eye sits inside the cloud, so the near cull and the frame edges
    # (Jacobian clamp, AABB clip) are all exercised.
    params, cam, tp, tc = _both(2000, seed=sh_degree, sh_degree=sh_degree,
                                eye=[0.2, 0.3, 2.5])
    cfg = JaxConfig(sh_degree=sh_degree, tight_radius=tight)
    ref = to_numpy(jax.jit(jax_preprocess, static_argnames="cfg")(params, cam, cfg=cfg))
    got = preprocess(tp, tc, convert.config_from_fields(dataclasses.asdict(cfg)))
    assert (ref.ntiles == 0).any() and (ref.ntiles > 0).any()
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f), rtol=1e-5,
                                   atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(got.aabb.numpy(), ref.aabb)
    np.testing.assert_array_equal(got.ntiles.numpy(), ref.ntiles)


@pytest.mark.parametrize("clamp", ["all", "none"])
def test_color_clamp_modes_match_jax(clamp):
    params, cam, tp, tc = _both(500, seed=7, sh_degree=3, eye=[0.0, 0.5, 6.0])
    cfg = JaxConfig(sh_degree=3, color_clamp=clamp)
    ref = to_numpy(jax_preprocess(params, cam, cfg))
    got = preprocess(tp, tc, convert.config_from_fields(dataclasses.asdict(cfg)))
    np.testing.assert_allclose(got.color.numpy(), ref.color, rtol=1e-5, atol=1e-4)


def test_dead_gaussians_are_culled():
    params, cam, tp, tc = _both(300, seed=3, sh_degree=0, eye=[0.0, 0.0, 6.0])
    alive = np.ones(300, bool)
    alive[::3] = False
    params = dataclasses.replace(params, alive=jnp.asarray(alive))
    tp = dataclasses.replace(tp, alive=torch.from_numpy(alive))
    cfg = JaxConfig(sh_degree=0)
    ref = to_numpy(jax_preprocess(params, cam, cfg))
    got = preprocess(tp, tc, convert.config_from_fields(dataclasses.asdict(cfg)))
    assert (got.ntiles.numpy()[~alive] == 0).all()
    np.testing.assert_array_equal(got.ntiles.numpy(), ref.ntiles)


def test_preprocess_gradients_match_jax():
    """Autograd through the port's preprocess against jax.grad of the same
    scalar function of its outputs."""
    params, cam, tp, tc = _both(400, seed=11, sh_degree=2, eye=[0.3, 0.2, 6.0])
    cfg = JaxConfig(sh_degree=2)
    tcfg = convert.config_from_fields(dataclasses.asdict(cfg))
    rng = np.random.default_rng(0)
    wts = {f: rng.normal(size=s).astype(np.float32)
           for f, s in (("uv", (400, 2)), ("conic", (400, 3)), ("opacity", (400,)),
                        ("color", (400, 3)), ("depth", (400,)))}
    fields = ("means", "log_scales", "quats", "opacities", "sh")

    def jax_loss(tr):
        pg = jax_preprocess(dataclasses.replace(params, **tr), cam, cfg)
        return sum(jnp.sum(getattr(pg, f) * w) * 1e-3 for f, w in wts.items())

    ref = jax.grad(jax_loss)({f: getattr(params, f) for f in fields})

    leaves = {f: getattr(tp, f).clone().requires_grad_(True) for f in fields}
    pg = preprocess(dataclasses.replace(tp, **leaves), tc, tcfg)
    loss = sum(torch.sum(getattr(pg, f) * torch.from_numpy(w)) * 1e-3 for f, w in wts.items())
    loss.backward()
    for f in fields:
        a = np.asarray(ref[f], np.float64)
        b = leaves[f].grad.numpy().astype(np.float64)
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4, err_msg=f)
