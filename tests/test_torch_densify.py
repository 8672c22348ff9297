"""The port's densification (tpusplat_torch/train/densify.py) on the CPU:
densify_and_prune fed the JAX package's own split draws against the JAX
densify_and_prune on the same state, and the five behavioural tests of
tests/test_densify.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.train import densify as jd
from tpusplat.train import step as jstep
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.train import densify as td
from tpusplat_torch.train import step as tstep

torch.set_num_threads(2)

FIELDS = tstep.TRAINABLE


def _state_with(n=64, n_alive=32):
    params = random_scene(n, seed=0, sh_degree=0, device="cpu")
    alive = torch.zeros(n, dtype=torch.bool)
    alive[:n_alive] = True
    params = dataclasses.replace(params, alive=alive)
    return tstep.create_train_state(params)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_densify_matches_jax_with_its_draws():
    """Clones, splits (2 of 3 with large scales), pruning by opacity and by
    world size, grants limited by free slots, and zeroed moments."""
    n, n_alive = 96, 70
    rng = np.random.default_rng(5)
    params = jax_random_scene(n, seed=4, sh_degree=1, scale_range=(0.005, 0.05))
    op = np.asarray(params.opacities).copy()
    op[3:6] = -9.0  # prune by opacity
    ls = np.asarray(params.log_scales).copy()
    ls[7] = np.log(0.5)  # prune by world size
    alive = np.zeros(n, bool)
    alive[:n_alive] = True
    params = dataclasses.replace(params, opacities=jnp.asarray(op),
                                 log_scales=jnp.asarray(ls), alive=jnp.asarray(alive))
    ga = rng.uniform(0, 4e-4, n).astype(np.float32)  # about half are candidates
    gc = rng.integers(0, 3, n).astype(np.float32)
    mr = rng.uniform(0, 5, n).astype(np.float32)
    moments = {f: rng.normal(size=np.asarray(getattr(params, f)).shape).astype(np.float32)
               for f in FIELDS}

    jopt = jstep.make_optimizer()
    js = jstep.create_train_state(params, jopt)
    inner = dict(js.opt_state.inner_states)
    for f in FIELDS:
        ms = inner[f]
        adam = ms.inner_state[0]
        adam = adam._replace(mu={**adam.mu, f: jnp.asarray(moments[f])},
                             nu={**adam.nu, f: jnp.asarray(moments[f] ** 2)})
        inner[f] = ms._replace(inner_state=(adam,) + tuple(ms.inner_state[1:]))
    js = dataclasses.replace(js, opt_state=js.opt_state._replace(inner_states=inner),
                             grad_accum=jnp.asarray(ga), grad_count=jnp.asarray(gc),
                             max_radii=jnp.asarray(mr))
    dcfg_j = jd.DensifyConfig(grad_threshold=1e-4, percent_dense=0.003, max_screen_radius=4.0)
    key = jax.random.key(7)
    out_j = jd.densify_and_prune(js, key, dcfg_j, scene_extent=2.0)
    noise = np.array(jax.random.normal(key, (n, 3)))
    noise2 = np.array(jax.random.normal(jax.random.fold_in(key, 1), (n, 3)))

    p = to_numpy(params)
    tp = convert.params_from_numpy(p.means, p.log_scales, p.quats, p.opacities, p.sh, p.alive,
                                   device="cpu")
    ts = tstep.create_train_state(tp)
    ts.mu = {f: torch.from_numpy(moments[f]) for f in FIELDS}
    ts.nu = {f: torch.from_numpy(moments[f] ** 2) for f in FIELDS}
    ts.grad_accum, ts.grad_count, ts.max_radii = (torch.from_numpy(a) for a in (ga, gc, mr))
    dcfg_t = td.DensifyConfig(**dataclasses.asdict(dcfg_j))
    out_t = td.densify_and_prune(ts, None, dcfg_t, 2.0, noise=torch.from_numpy(noise),
                                 noise2=torch.from_numpy(noise2))

    alive_j = np.asarray(out_j.params.alive)
    np.testing.assert_array_equal(out_t.params.alive.numpy(), alive_j)
    assert alive_j.sum() > n_alive - 4 and not alive_j[[3, 4, 5, 7]].any()
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out_t.params, f).numpy(),
                                   np.asarray(getattr(out_j.params, f)), atol=1e-6,
                                   err_msg=f)
        adam = out_j.opt_state.inner_states[f].inner_state[0]
        np.testing.assert_array_equal(out_t.mu[f].numpy(), np.asarray(adam.mu[f]), err_msg=f)
        np.testing.assert_array_equal(out_t.nu[f].numpy(), np.asarray(adam.nu[f]), err_msg=f)
    for f in ("grad_accum", "grad_count", "max_radii"):
        assert not getattr(out_t, f).any()
    assert int(out_t.step) == int(out_j.step)


def test_clone_into_free_slots():
    state = _state_with()
    ga = torch.zeros(64)
    ga[:4] = 1.0
    state = dataclasses.replace(state, grad_accum=ga, grad_count=torch.ones(64))
    dcfg = td.DensifyConfig(grad_threshold=0.5, percent_dense=10.0, max_world_scale=0.0)
    out = td.densify_and_prune(state, _gen(), dcfg, scene_extent=1.0)
    alive = out.params.alive.numpy()
    assert alive.sum() == 36  # 32 alive + 4 clones
    new_slots = np.where(alive[32:])[0] + 32
    assert len(new_slots) == 4
    src_means = state.params.means.numpy()[:4]
    for m in out.params.means.numpy()[new_slots]:
        assert np.min(np.linalg.norm(src_means - m, axis=1)) < 1e-6


def test_split_shrinks_and_moves():
    state = _state_with()
    ga = torch.zeros(64)
    ga[:2] = 1.0
    state = dataclasses.replace(state, grad_accum=ga, grad_count=torch.ones(64))
    dcfg = td.DensifyConfig(grad_threshold=0.5, percent_dense=1e-6, max_world_scale=0.0)
    out = td.densify_and_prune(state, _gen(1), dcfg, scene_extent=1.0)
    np.testing.assert_allclose(out.params.log_scales.numpy()[:2],
                               state.params.log_scales.numpy()[:2] - np.log(1.6), rtol=1e-6)
    assert np.abs(out.params.means.numpy()[:2] - state.params.means.numpy()[:2]).max() > 1e-5
    assert out.params.alive.sum() == 34


def test_prune_low_opacity():
    state = _state_with()
    op = state.params.opacities.clone()
    op[:5] = -10.0  # sigmoid ~ 4.5e-5 < min_opacity
    state = dataclasses.replace(state, params=dataclasses.replace(state.params, opacities=op))
    out = td.densify_and_prune(state, _gen(), td.DensifyConfig(max_world_scale=0.0), 1.0)
    alive = out.params.alive.numpy()
    assert not alive[:5].any()
    assert alive[5:32].all()


def test_grant_limited_by_free_slots():
    state = _state_with(n=64, n_alive=62)  # only 2 free slots
    state = dataclasses.replace(state, grad_accum=torch.ones(64), grad_count=torch.ones(64))
    dcfg = td.DensifyConfig(grad_threshold=0.5, percent_dense=10.0, max_world_scale=0.0)
    out = td.densify_and_prune(state, _gen(), dcfg, 1.0)
    assert out.params.alive.sum() == 64  # all slots filled, no more


def test_opacity_reset():
    state = _state_with()
    out = td.reset_opacity(state, ceiling=0.01)
    sig = torch.sigmoid(out.params.opacities).numpy()
    assert (sig <= 0.0101).all()
    js = jstep.create_train_state(jax_random_scene(64, seed=0, sh_degree=0),
                                  jstep.make_optimizer())
    np.testing.assert_array_equal(out.params.opacities.numpy(),
                                  np.asarray(jd.reset_opacity(js, 0.01).params.opacities))
