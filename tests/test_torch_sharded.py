"""The port's tile-sharded path (tpusplat_torch/parallel/) over gloo on the
CPU, four processes started once for the module (``file://`` rendezvous in a
temporary directory), against the JAX package on its virtual CPU devices:

  * ``render_sharded`` on 2x2, 1x4 and 4x1 meshes against the JAX
    ``render_stages`` of each camera (the bound of tests/test_sharded.py);
  * ``sharded_train_step`` on a 2x2 mesh against the JAX
    ``sharded_train_step`` on a 2x2 mesh: the loss, the parameters after
    the update, and Adam's moments (after one step mu = 0.1 g and
    nu = 0.001 g^2: the reduced gradient's magnitude, which the update,
    -lr sign(g) at the first step, does not show);
  * the overlap step (ring and all-reduce) against the monolithic step,
    parameters and moments;
  * tests/test_regrow.py::test_sharded_train_step_overflow_is_noop on the
    2x2 mesh: an overflowed sharded step leaves the state as it was on
    every rank, and the retry at the regrown capacity applies the update.

The compact exchange has its own file, tests/test_torch_compact_grad.py.
The JAX side runs through its XLA path (``use_pallas=False``)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tpusplat_torch.config import RenderConfig

torch.set_num_threads(2)

MESHES = ((2, 2), (1, 4), (4, 1))
FIELDS = ("means", "log_scales", "quats", "opacities", "sh")


def _scene_cfg():
    """tests/test_sharded.py's _setup: 512 Gaussians, 96x64, SH1."""
    return dict(sh_degree=1, max_per_tile=256, tile_chunk=4, gauss_chunk=16, capacity_mult=16)


def _eyes(batch):
    return [[math.sin(i) * 2, 0.3, 6.0] for i in range(batch)]


def _jax_params(n, seed, sort_by_y=False):
    from tpusplat.io.synthetic import random_scene
    from tpusplat.types import to_numpy

    p = dataclasses.asdict(to_numpy(random_scene(n, seed=seed, sh_degree=1,
                                                 scale_range=(0.05, 0.3))))
    if sort_by_y:  # ids follow screen rows: a strip's stream ids nearly contiguous
        order = np.argsort(p["means"][:, 1], kind="stable")
        p = {k: v[order] for k, v in p.items()}
    return p  # plain numpy: the worker processes never import JAX


def _torch_params(p):
    from tpusplat_torch import convert

    return convert.params_from_numpy(**p, device="cpu")


def _cams(width, height, batch):
    from tpusplat_torch.camera import look_at_camera

    return [look_at_camera(e, [0, 0, 0], width, height, fov_deg=60.0, device="cpu")
            for e in _eyes(batch)]


def _targets(batch, height, width):
    return np.random.default_rng(0).uniform(0, 1, (batch, height, width, 3)).astype(np.float32)


def _worker(rank, dev, inputs, out_dir):
    """One rank: every mesh computation of the module; rank 0 saves the
    results (every rank's renders, the parameters gathered over ``tile``)."""
    from tpusplat_torch.parallel import sharded
    from tpusplat_torch.parallel.mesh import make_render_mesh
    from tpusplat_torch.train import step as tstep

    res = {}
    params = _torch_params(inputs["small"])
    cfg = RenderConfig(**_scene_cfg())
    cams = _cams(96, 64, 4)
    for d, t in MESHES:
        mesh = make_render_mesh(d, t)
        imgs, counters = sharded.render_sharded(sharded.shard_params(params, mesh), cams, cfg,
                                                mesh)
        res[f"render_{d}x{t}_{rank}"] = (imgs, {k: int(v) for k, v in counters.items()})
    res_all = [None] * 4
    torch.distributed.all_gather_object(res_all, res)

    opt = tstep.make_optimizer()
    mesh = make_render_mesh(2, 2)
    state = sharded.shard_state(tstep.create_train_state(params), mesh)
    tgt = torch.from_numpy(inputs["targets"])
    steps = {}
    for name, kw, fn in (("dense", {}, sharded.sharded_train_step),
                         ("ring", dict(grad_reduce="ring"), sharded.sharded_train_step_overlap),
                         ("psum", dict(grad_reduce="psum"), sharded.sharded_train_step_overlap)):
        s1, m = fn(state, cams[:2], tgt, cfg, opt, mesh, **kw)
        steps[name] = _summary(s1, m, mesh)
    regrow = _overflow_noop(inputs["regrow"], opt, mesh)
    if rank == 0:
        torch.save(dict(renders=res_all, steps=steps, regrow=regrow), f"{out_dir}/result.pt")


def _overflow_noop(p, opt, mesh):
    """tests/test_regrow.py's sharded case: inflated scales at a capacity
    of 256; then regrow and retry until the step applies (every rank
    agrees: the counters are summed over the mesh). Returns what every
    rank saw."""
    from tpusplat_torch.camera import look_at_camera
    from tpusplat_torch.config import regrow
    from tpusplat_torch.parallel import sharded
    from tpusplat_torch.train import step as tstep

    params = _torch_params(p)
    params = dataclasses.replace(params, log_scales=params.log_scales + 2.5)
    cam = look_at_camera([0.2, 0.1, 6.0], [0, 0, 0], 64, 48, fov_deg=60.0, device="cpu")
    cfg = RenderConfig(sh_degree=1, capacity=256, max_per_tile=2048, tile_chunk=4,
                       gauss_chunk=16)
    state0 = sharded.shard_state(tstep.create_train_state(params), mesh)
    targets = torch.zeros((2, 48, 64, 3))
    state1, m1 = sharded.sharded_train_step(state0, [cam, cam], targets, cfg, opt, mesh)
    same = all(torch.equal(a, b) for a, b in (
        (state1.params.means, state0.params.means), (state1.mu["sh"], state0.mu["sh"]),
        (state1.grad_accum, state0.grad_accum)))
    out = dict(overflow=int(m1["capacity_overflow"]), step=int(state1.step), same=same,
               retries=0)
    state2, m2 = state1, m1
    while out["retries"] < 8:
        cfg, changes = regrow(cfg, m2, state0.params.num_gaussians)
        if changes is None:
            break
        out["retries"] += 1
        state2, m2 = sharded.sharded_train_step(state1, [cam, cam], targets, cfg, opt, mesh)
    out.update(step2=int(state2.step), overflow2=int(m2["capacity_overflow"]),
               moved=not torch.equal(state2.params.means, state0.params.means))
    everyone = [None] * mesh.data * mesh.tile
    torch.distributed.all_gather_object(everyone, out)
    return everyone


def _summary(state, metrics, mesh):
    from tpusplat_torch.parallel import sharded

    full = sharded.gather_state(state, mesh)
    return dict(params={f: getattr(full.params, f) for f in FIELDS},
                mu={f: full.mu[f] for f in FIELDS}, nu={f: full.nu[f] for f in FIELDS},
                step=int(state.step),
                **{k: float(v) if k == "loss" else int(v) for k, v in metrics.items()})


def assert_moments_close(got, want_mu, want_nu, tol):
    """Adam's moments of every field within ``tol`` of the largest
    magnitude of the field's wanted moment (a gradient scaled by 2 is off
    by 1.0 in mu, 3.0 in nu)."""
    for m, want in (("mu", want_mu), ("nu", want_nu)):
        for f in FIELDS:
            w = np.asarray(want[f])
            scale = np.abs(w).max()
            assert scale > 0, f"{m} {f} is zero"
            np.testing.assert_allclose(np.asarray(got[m][f]), w, rtol=0, atol=tol * scale,
                                       err_msg=f"{m} {f}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tpusplat_torch.parallel.launch import spawn

    out = tmp_path_factory.mktemp("sharded")
    inputs = dict(small=_jax_params(512, 5), targets=_targets(2, 64, 96),
                  regrow=_jax_params(512, 3))
    spawn(_worker, 4, (inputs, str(out)), init_file=str(out / "init"), device="cpu")
    return inputs, torch.load(out / "result.pt", weights_only=False)


def _jax_cfg(**kw):
    from tpusplat.config import RenderConfig as JaxConfig

    return JaxConfig(**{**_scene_cfg(), **kw})


def _jax_cam(eye, width, height):
    from tpusplat.camera import look_at_camera

    return look_at_camera(eye, [0, 0, 0], width, height, fov_deg=60.0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_render_sharded_matches_jax_render_stages(runs, mesh):
    import jax

    from tpusplat.render import render_stages
    from tpusplat.types import GaussianParams

    inputs, res = runs
    d, t = mesh
    p = GaussianParams(**{k: jax.numpy.asarray(v) for k, v in inputs["small"].items()})
    refs = [np.asarray(render_stages(p, _jax_cam(e, 96, 64), _jax_cfg())[0])
            for e in _eyes(4)]
    per = 4 // d
    for rank in range(4):
        imgs, counters = res["renders"][rank][f"render_{d}x{t}_{rank}"]
        assert counters["capacity_overflow"] == counters["tile_overflow"] == 0
        assert imgs.shape == (per, 64, 96, 3)
        for j in range(per):
            np.testing.assert_allclose(imgs[j].numpy(), refs[(rank // t) * per + j],
                                       atol=1e-5, rtol=1e-4, err_msg=f"rank {rank} camera {j}")


def test_sharded_train_step_matches_jax_on_2x2(runs):
    """The loss at rtol 1e-5 and the parameters after the update at atol
    2e-6 (tests/test_sharded.py's bounds against the unsharded step); Adam's
    moments within 1e-4 of their largest magnitude."""
    import jax
    import jax.numpy as jnp

    from tpusplat.parallel.mesh import make_render_mesh
    from tpusplat.parallel.sharded import params_sharding, sharded_train_step
    from tpusplat.train.step import create_train_state, make_optimizer
    from tpusplat.types import GaussianParams, stack_cameras

    inputs, res = runs
    p = GaussianParams(**{k: jnp.asarray(v) for k, v in inputs["small"].items()})
    mesh = make_render_mesh(data=2, tile=2, devices=jax.devices()[:4])
    opt = make_optimizer()
    state = create_train_state(p, opt)
    state = dataclasses.replace(state, params=jax.device_put(state.params,
                                                             params_sharding(mesh)))
    cams = stack_cameras([_jax_cam(e, 96, 64) for e in _eyes(2)])
    state, m = sharded_train_step(state, cams, jnp.asarray(inputs["targets"]), _jax_cfg(), opt,
                                  mesh)
    got = res["steps"]["dense"]
    assert got["step"] == int(state.step) == 1
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    for f in FIELDS:
        np.testing.assert_allclose(got["params"][f].numpy(), np.asarray(getattr(state.params, f)),
                                   atol=2e-6, err_msg=f)
    adam = {f: state.opt_state.inner_states[f].inner_state[0] for f in FIELDS}
    assert_moments_close(got, {f: adam[f].mu[f] for f in FIELDS},
                         {f: adam[f].nu[f] for f in FIELDS}, 1e-4)


@pytest.mark.parametrize("reduce", ["ring", "psum"])
def test_overlap_step_matches_monolithic(runs, reduce):
    _, res = runs
    ref, got = res["steps"]["dense"], res["steps"][reduce]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert got["step"] == ref["step"] == 1
    for f in FIELDS:
        np.testing.assert_allclose(got["params"][f].numpy(), ref["params"][f].numpy(),
                                   atol=3e-6, err_msg=f)
    assert_moments_close(got, ref["mu"], ref["nu"], 1e-4)


def test_sharded_train_step_overflow_is_noop(runs):
    """tests/test_regrow.py::test_sharded_train_step_overflow_is_noop on the
    2x2 mesh (the reference takes 2x4): the overflowed step leaves the
    step count, the parameters, Adam's moments and the statistics as they
    were on every rank; the retry at a regrown capacity applies the step."""
    _, res = runs
    for rank, r in enumerate(res["regrow"]):
        assert r["overflow"] > 0 and r["step"] == 0 and r["same"], (rank, r)
        assert 1 <= r["retries"] < 8 and r["overflow2"] == 0, (rank, r)
        assert r["step2"] == 1 and r["moved"], (rank, r)
