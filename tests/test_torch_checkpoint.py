"""The port's checkpoint (tpusplat_torch/train/checkpoint.py) on the CPU: the
whole TrainState round trip (the counterpart of
tests/test_densify.py::test_checkpoint_roundtrip_npz), the ``.npz``-only
rule, and a JAX state carried into the port (convert.train_state_from_numpy)
through a checkpoint, then stepped on both sides."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.train import step as jstep
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.train import step as tstep
from tpusplat_torch.train.checkpoint import load_checkpoint, save_checkpoint, state_tensors

torch.set_num_threads(2)

FIELDS = tstep.TRAINABLE


def _busy_state(n=200):
    """A state whose every tensor holds something other than its initial value."""
    g = torch.Generator().manual_seed(0)
    params = random_scene(n, seed=2, sh_degree=1, device="cpu")
    alive = torch.rand(n, generator=g) < 0.7
    state = tstep.create_train_state(dataclasses.replace(params, alive=alive))
    state.mu = {k: torch.randn(v.shape, generator=g) for k, v in state.mu.items()}
    state.nu = {k: torch.rand(v.shape, generator=g) for k, v in state.nu.items()}
    state.count = {k: torch.tensor(5 + i, dtype=torch.int32) for i, k in enumerate(FIELDS)}
    state.step = torch.tensor(7, dtype=torch.int32)
    state.grad_accum = torch.rand(n, generator=g)
    state.grad_count = torch.randint(0, 9, (n,), generator=g).float()
    state.max_radii = torch.rand(n, generator=g) * 30
    return state


def test_checkpoint_roundtrip_npz(tmp_path):
    state = _busy_state()
    path = tmp_path / "ck.npz"
    save_checkpoint(path, state)
    like = tstep.create_train_state(random_scene(200, seed=9, sh_degree=1, device="cpu"))
    restored = load_checkpoint(path, like)
    want, got, ref = state_tensors(state), state_tensors(restored), state_tensors(like)
    assert set(got) == set(want) and len(want) == 6 + 3 * len(FIELDS) + 4
    for k, v in want.items():
        assert got[k].dtype == ref[k].dtype and got[k].device == ref[k].device, k
        assert torch.equal(got[k], v), k
    assert int(restored.step) == 7 and int(restored.count["sh"]) == 9


def test_checkpoint_refuses_other_paths_and_shapes(tmp_path):
    state = _busy_state()
    with pytest.raises(ValueError, match=".npz"):
        save_checkpoint(tmp_path / "ck", state)
    with pytest.raises(ValueError, match=".npz"):
        load_checkpoint(str(tmp_path / "ck"), state)
    save_checkpoint(tmp_path / "ck.npz", state)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path / "ck.npz", _busy_state(100))


def test_jax_state_carried_through_a_checkpoint(tmp_path):
    """One JAX train_step, the state carried into the port and through a
    checkpoint, then one more step on each side: the loss at rtol 1e-4 and
    the parameters within tests/test_torch_train.py's bounds (2 lr steps
    per step)."""
    params = jax_random_scene(400, seed=6, sh_degree=1, scale_range=(0.05, 0.3))
    cam = jax_look_at([0.3, 0.2, 6.0], [0, 0, 0], 64, 48, fov_deg=60.0)
    cfg = JaxConfig(sh_degree=1, max_per_tile=512, tile_chunk=4, gauss_chunk=16)
    target = np.random.default_rng(0).uniform(0, 1, (48, 64, 3)).astype(np.float32)
    kw = dict(scene_extent=2.0, means_lr_max_steps=10)
    jopt, topt = jstep.make_optimizer(**kw), tstep.make_optimizer(**kw)
    js, _ = jstep.train_step(jstep.create_train_state(params, jopt), cam, jnp.asarray(target),
                             cfg, jopt)

    adam = {f: js.opt_state.inner_states[f].inner_state[0] for f in FIELDS}
    carried = convert.train_state_from_numpy(
        params=dataclasses.asdict(to_numpy(js.params)),
        mu={f: np.asarray(adam[f].mu[f]) for f in FIELDS},
        nu={f: np.asarray(adam[f].nu[f]) for f in FIELDS},
        count={f: np.asarray(adam[f].count) for f in FIELDS}, step=np.asarray(js.step),
        grad_accum=np.asarray(js.grad_accum), grad_count=np.asarray(js.grad_count),
        max_radii=np.asarray(js.max_radii), device="cpu")
    assert int(carried.step) == 1 and int(carried.count["means"]) == 1
    save_checkpoint(tmp_path / "carried.npz", carried)
    ts = load_checkpoint(tmp_path / "carried.npz", carried)
    for k, v in state_tensors(carried).items():
        assert torch.equal(state_tensors(ts)[k], v), k

    c = to_numpy(cam)
    tc = convert.camera_from_numpy(c.view, c.proj, c.cam_pos, c.tan_fovx, c.tan_fovy,
                                   c.width, c.height, device="cpu")
    tcfg = convert.config_from_fields(dataclasses.asdict(cfg))
    js, jm = jstep.train_step(js, cam, jnp.asarray(target), cfg, jopt)
    ts, tm = tstep.train_step(ts, tc, torch.from_numpy(target), tcfg, topt)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    assert int(ts.step) == int(js.step) == 2 and int(ts.count["sh"]) == 2
    lrs = dict(means=topt.means_lr * topt.scene_extent, log_scales=topt.scales_lr,
               quats=topt.quats_lr, opacities=topt.opacities_lr, sh=topt.sh_lr)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ts.params, f).numpy(),
                                   np.asarray(getattr(js.params, f)), atol=2 * lrs[f] * 2,
                                   err_msg=f)
