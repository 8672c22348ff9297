"""The port's gradient path on the CPU against the JAX package: the five
parameter gradients through ``_RasterCore`` and ``_PackGather`` (the plain
backward blend, the gradient sort and the plain segment reduce) against
``jax.grad`` of the XLA path at tests/test_pallas_rasterize.py's settings and
of the Pallas path (interpret mode); the transmittance cotangent; the dead
slots past the last instance; the segment reduce against numpy.

Gradients are compared normalised by each parameter's largest magnitude at
atol 1e-4, the bound of tests/test_pallas_rasterize.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.render import render_stages as jax_render_stages
from tpusplat.train.step import merge_trainable as jax_merge, split_trainable as jax_split
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.ops import rasterize, segment_reduce
from tpusplat_torch.render import render_stages

torch.set_num_threads(2)

FIELDS = ("means", "log_scales", "quats", "opacities", "sh")


def _setup(n=400, w=64, h=48, sh_degree=1, seed=6, use_pallas=False):
    params = jax_random_scene(n, seed=seed, sh_degree=sh_degree, scale_range=(0.05, 0.3))
    cam = jax_look_at([0.3, 0.2, 6.0], [0, 0, 0], w, h, fov_deg=60.0)
    cfg = JaxConfig(sh_degree=sh_degree, max_per_tile=512, tile_chunk=4, gauss_chunk=16,
                    use_pallas=use_pallas)
    return params, cam, cfg


def _port(params, cam, cfg):
    p, c = to_numpy(params), to_numpy(cam)
    tp = convert.params_from_numpy(p.means, p.log_scales, p.quats, p.opacities, p.sh,
                                   p.alive, device="cpu")
    tc = convert.camera_from_numpy(c.view, c.proj, c.cam_pos, c.tan_fovx, c.tan_fovy,
                                   c.width, c.height, device="cpu")
    return tp, tc, convert.config_from_fields(dataclasses.asdict(cfg))


def _jax_grads(params, cam, cfg, loss_of):
    trainable, alive = jax_split(params)

    def loss(tr):
        img, aux = jax_render_stages(jax_merge(tr, alive), cam, cfg)
        return loss_of(img, aux["transmittance"], jnp)

    return jax.grad(loss)(trainable)


def _torch_grads(params, cam, cfg, loss_of):
    tp, tc, tcfg = _port(params, cam, cfg)
    leaves = {f: getattr(tp, f).clone().requires_grad_(True) for f in FIELDS}
    img, aux = render_stages(dataclasses.replace(tp, **leaves), tc, tcfg)
    assert int(aux["capacity_overflow"]) == 0 and int(aux["tile_overflow"]) == 0
    loss_of(img, aux["transmittance"], torch).backward()
    return {f: v.grad for f, v in leaves.items()}


def _assert_grads_close(g_jax, g_torch, fields=FIELDS):
    for f in fields:
        a = np.asarray(g_jax[f], np.float64)
        b = g_torch[f].numpy().astype(np.float64)
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4, err_msg=f)


def _mse_to(target):
    def loss_of(img, tmap, xp):
        t = xp.asarray(target) if xp is jnp else torch.from_numpy(target)
        return xp.mean((img - t) ** 2)

    return loss_of


def _mean_t(img, tmap, xp):
    return xp.mean(tmap)


def test_grads_match_jax_xla():
    params, cam, cfg = _setup()
    target = np.random.default_rng(0).uniform(0, 1, (cam.height, cam.width, 3)).astype(
        np.float32)
    _assert_grads_close(_jax_grads(params, cam, cfg, _mse_to(target)),
                        _torch_grads(params, cam, cfg, _mse_to(target)))


def test_transmittance_cotangent_matches_jax():
    """The dT channel alone: the loss reads only the final transmittance."""
    params, cam, cfg = _setup(n=150, w=32, h=32)
    _assert_grads_close(_jax_grads(params, cam, cfg, _mean_t),
                        _torch_grads(params, cam, cfg, _mean_t))


def test_grads_match_jax_pallas_interpret():
    """Against the Pallas kernels (interpret mode); this scene does not
    saturate, so the JAX paths agree on it."""
    params, cam, cfg = _setup(n=150, w=32, h=32, use_pallas=True)
    target = np.random.default_rng(1).uniform(0, 1, (32, 32, 3)).astype(np.float32)

    def loss_of(img, tmap, xp):
        return _mse_to(target)(img, tmap, xp) + 0.5 * xp.mean(tmap)

    _assert_grads_close(_jax_grads(params, cam, cfg, loss_of),
                        _torch_grads(params, cam, cfg, loss_of))


def test_gather_backward_drops_dead_slots():
    """Slots past the last instance carry gid N and, on the card, stale
    gradient rows. The gather's backward keys on the raw gid: Gaussian N-1
    gets only its own rows, never the dead slots' (autograd of the clamped
    index_select would add them all to it)."""
    rng = np.random.default_rng(3)
    n, c, live = 50, 4096, 300  # capacity well above the instances
    gid = np.full(c, n, np.int32)
    gid[:live] = np.sort(rng.integers(0, n, live))
    gid[live - 5:live] = n - 1  # Gaussian N-1 owns live rows too
    d_attr = rng.normal(size=(9, c)).astype(np.float32)
    d_attr[:, live:] = np.nan  # stale memory past the last instance
    table = torch.from_numpy(rng.normal(size=(9, n)).astype(np.float32)).requires_grad_(True)
    attr = rasterize._PackGather.apply(table, torch.from_numpy(gid))
    np.testing.assert_array_equal(attr.detach().numpy(),
                                  table.detach().numpy()[:, np.minimum(gid, n - 1)])
    attr.backward(torch.from_numpy(d_attr))
    want = np.zeros((9, n), np.float32)
    np.add.at(want.T, gid[:live], d_attr[:, :live].T)
    got = table.grad.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, n - 1], want[:, n - 1], atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_render_grads_with_ample_capacity_match_jax():
    """End to end with a capacity far above the instances (many dead slots)."""
    params, cam, cfg = _setup(n=120, w=32, h=32)
    cfg = dataclasses.replace(cfg, capacity_mult=64)
    target = np.full((32, 32, 3), 0.25, np.float32)
    _assert_grads_close(_jax_grads(params, cam, cfg, _mse_to(target)),
                        _torch_grads(params, cam, cfg, _mse_to(target)))


def test_segment_reduce_plain_vs_numpy():
    """Dense mode with sentinel ids (N, past the end) holding NaN rows, as
    tests/test_compact_grad.py's reduces hold stale memory."""
    rng = np.random.default_rng(1)
    n, c = 5000, 4096
    gid = np.sort(rng.integers(0, n, c)).astype(np.int32)
    gid[-300:] = n
    rows = rng.normal(size=(9, c)).astype(np.float32)
    rows[:, -300:] = np.nan
    bounds = np.searchsorted(gid, np.arange(n + 1), side="left").astype(np.int32)
    got = segment_reduce.segment_reduce(torch.from_numpy(rows), torch.from_numpy(gid),
                                        torch.from_numpy(bounds)).numpy()
    ref = np.zeros((9, n), np.float32)
    for g in np.unique(gid[gid < n]):
        ref[:, g] = rows[:, gid == g].sum(axis=1)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_backward_uses_plain_versions_on_cpu():
    """A CPU tensor never reaches a kernel: the launch counters stay."""
    params, cam, cfg = _setup(n=60, w=32, h=32)
    before = (rasterize.FORWARD_LAUNCHES, rasterize.BACKWARD_LAUNCHES,
              segment_reduce.LAUNCHES)
    grads = _torch_grads(params, cam, cfg, _mean_t)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert (rasterize.FORWARD_LAUNCHES, rasterize.BACKWARD_LAUNCHES,
            segment_reduce.LAUNCHES) == before


@pytest.mark.parametrize("used", ["image", "transmittance"])
def test_unused_cotangent_counts_as_zero(used):
    """When only one output reaches the loss, the other's cotangent acts
    as zeros."""
    params, cam, cfg = _setup(n=60, w=32, h=32)
    tp, tc, tcfg = _port(params, cam, cfg)

    def grad(both):
        means = tp.means.clone().requires_grad_(True)
        img, aux = render_stages(dataclasses.replace(tp, means=means), tc, tcfg)
        a, b = (img, aux["transmittance"]) if used == "image" else (aux["transmittance"], img)
        loss = a.sum() + (0.0 * b.sum() if both else 0.0)
        return torch.autograd.grad(loss, means)[0].numpy()

    g = grad(False)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(g, grad(True), rtol=1e-6, atol=1e-7)
