"""The port's checkpoint (tpusplat_torch/train/checkpoint.py) on the CPU, in
the JAX package's ``.npz`` layout: the whole TrainState round trip (the
counterpart of tests/test_densify.py::test_checkpoint_roundtrip_npz), the
``.npz``-only rule, a file of ``tpusplat.train.checkpoint.save_checkpoint``
read by the port and a file of the port read by the JAX package's
``load_checkpoint``, bit for bit, then stepped on both sides; the treedef
constant against JAX's; and the refusals."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.train import checkpoint as jckpt
from tpusplat.train import step as jstep
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.train import step as tstep
from tpusplat_torch.train.checkpoint import (JAX_LEAVES, JAX_TREEDEF, load_checkpoint,
                                             save_checkpoint, state_tensors)

torch.set_num_threads(2)

FIELDS = tstep.TRAINABLE
W, H = 64, 48
STEP_KW = dict(scene_extent=2.0, means_lr_max_steps=10)


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


def _jax_setup(n, sh_degree, seed=6):
    """A JAX scene (a fifth of its slots dead), camera, target, config and
    optimizer, and the port's camera and config for the same frame."""
    params = jax_random_scene(n, seed=seed, sh_degree=sh_degree, scale_range=(0.05, 0.3))
    dead = np.random.default_rng(seed).uniform(0, 1, n) < 0.2
    params = dataclasses.replace(params, alive=jnp.asarray(~dead))
    cam = jax_look_at([0.3, 0.2, 6.0], [0, 0, 0], W, H, fov_deg=60.0)
    cfg = JaxConfig(sh_degree=sh_degree, max_per_tile=512, tile_chunk=4, gauss_chunk=16)
    target = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    c = to_numpy(cam)
    tc = convert.camera_from_numpy(c.view, c.proj, c.cam_pos, c.tan_fovx, c.tan_fovy,
                                   c.width, c.height, device="cpu")
    return params, cam, cfg, target, tc, convert.config_from_fields(dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _jax_stepped(n, sh_degree):
    """The JAX state after one train_step (every count 1)."""
    params, cam, cfg, target, _, _ = _jax_setup(n, sh_degree)
    jopt = jstep.make_optimizer(**STEP_KW)
    js, _ = jstep.train_step(jstep.create_train_state(params, jopt), cam, jnp.asarray(target),
                             cfg, jopt)
    return js


def _port_like(n, sh_degree):
    return tstep.create_train_state(random_scene(n, seed=9, sh_degree=sh_degree, device="cpu"))


def _assert_leaves_equal(port_state, jax_state):
    """Every tensor of the port's state bit-equal to the JAX state's,
    paired by name (``opt_state.inner_states[group].inner_state[0]`` holds
    Adam's count, mu and nu, ``inner_state[1]`` of the means their schedule's
    count), and in the JAX leaf order, dtypes and shapes included."""
    groups = jax_state.opt_state.inner_states
    adam = {f: groups[f].inner_state[0] for f in FIELDS}
    pairs = [(getattr(port_state.params, f.name), getattr(jax_state.params, f.name))
             for f in dataclasses.fields(port_state.params)]
    for f in FIELDS:
        pairs += [(port_state.mu[f], adam[f].mu[f]), (port_state.nu[f], adam[f].nu[f]),
                  (port_state.count[f], adam[f].count)]
    pairs.append((port_state.count["means"], groups["means"].inner_state[1].count))
    pairs += [(getattr(port_state, k), getattr(jax_state, k))
              for k in ("step", "grad_accum", "grad_count", "max_radii")]
    leaves = jax.tree_util.tree_leaves(jax_state)
    assert len(leaves) == len(JAX_LEAVES)
    pairs += list(zip(state_tensors(port_state).values(), leaves))
    for i, (got, want) in enumerate(pairs):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype and tuple(got.shape) == want.shape, i
        assert np.array_equal(got.numpy(), want), i


def _step_both(ts, js, n, sh_degree):
    """One more train_step on each side: the loss at rtol 1e-4 and the
    parameters within 2 lr steps a step (tests/test_torch_train.py's bounds)."""
    _, cam, cfg, target, tc, tcfg = _jax_setup(n, sh_degree)
    jopt, topt = jstep.make_optimizer(**STEP_KW), tstep.make_optimizer(**STEP_KW)
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


def test_checkpoint_roundtrip_npz(tmp_path):
    state = _busy_state()
    path = tmp_path / "ck.npz"
    save_checkpoint(path, state)
    with np.load(path) as data:
        assert len(data.files) == len(JAX_LEAVES) + 1 == 27
    like = tstep.create_train_state(random_scene(200, seed=9, sh_degree=1, device="cpu"))
    restored = load_checkpoint(path, like)
    want, got, ref = state_tensors(state), state_tensors(restored), state_tensors(like)
    assert list(got) == list(want) == list(JAX_LEAVES)
    assert len(want) == 6 + 3 * len(FIELDS) + 1 + 4
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


@pytest.mark.parametrize("n", [300, 1000])
@pytest.mark.parametrize("sh_degree", [0, 3])
def test_jax_checkpoint_loads_into_the_port(tmp_path, sh_degree, n):
    """A file of the JAX package's save_checkpoint (compressed), after one
    JAX train_step: every tensor the port reads is bit-equal to its leaf."""
    js = _jax_stepped(n, sh_degree)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, js)
    ts = load_checkpoint(path, _port_like(n, sh_degree))
    _assert_leaves_equal(ts, js)
    assert int(ts.step) == 1 and all(int(c) == 1 for c in ts.count.values())
    assert 0 < int(ts.params.alive.sum()) < n


@pytest.mark.parametrize("n", [300, 1000])
@pytest.mark.parametrize("sh_degree", [0, 3])
def test_treedef_constant_is_jax_s(tmp_path, sh_degree, n):
    """JAX_TREEDEF is the str() of the JAX state's treedef, and the bytes
    the two packages write under __treedef__ are the same."""
    js = _jax_stepped(n, sh_degree)
    assert JAX_TREEDEF == str(jax.tree_util.tree_structure(js))
    jckpt.save_checkpoint(str(tmp_path / "jax.npz"), js)
    save_checkpoint(tmp_path / "port.npz", _port_like(n, sh_degree))
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert a["__treedef__"].dtype == b["__treedef__"].dtype == np.uint8
        assert a["__treedef__"].tobytes() == b["__treedef__"].tobytes()
        assert sorted(a.files) == sorted(b.files)


def test_jax_state_carried_through_a_checkpoint(tmp_path):
    """One JAX train_step, the state written by the JAX package and read by
    the port, then one more step on each side: the loss at rtol 1e-4 and
    the parameters within tests/test_torch_train.py's bounds (2 lr steps
    per step)."""
    n, sh = 400, 1
    js = _jax_stepped(n, sh)
    path = str(tmp_path / "carried.npz")
    jckpt.save_checkpoint(path, js)
    ts = load_checkpoint(path, _port_like(n, sh))
    assert int(ts.step) == 1 and int(ts.count["means"]) == 1
    _assert_leaves_equal(ts, js)
    _step_both(ts, js, n, sh)


def test_port_checkpoint_loads_into_jax(tmp_path):
    """One port train_step, the state written by the port and read by the
    JAX package's load_checkpoint: every leaf bit-equal to the port's
    tensor; then one more step on each side, as above."""
    n, sh = 400, 1
    params, _, _, target, tc, tcfg = _jax_setup(n, sh)
    ts = tstep.create_train_state(convert.params_from_numpy(
        **dataclasses.asdict(to_numpy(params)), device="cpu"))
    ts, _ = tstep.train_step(ts, tc, torch.from_numpy(target), tcfg,
                             tstep.make_optimizer(**STEP_KW))
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, ts)
    like = jstep.create_train_state(jax_random_scene(n, seed=9, sh_degree=sh),
                                    jstep.make_optimizer(**STEP_KW))
    js = jckpt.load_checkpoint(path, like)
    _assert_leaves_equal(ts, js)
    assert int(js.step) == 1
    _step_both(ts, js, n, sh)


def _rewrite(path, **change):
    """The .npz at ``path`` rewritten with ``change`` (None drops a file)."""
    with np.load(path) as data:
        files = {k: data[k] for k in data.files}
    for k, v in change.items():
        if v is None:
            del files[k]
        else:
            files[k] = v
    np.savez(path, **files)


def _old_named_layout(path, state):
    """The port's earlier layout: a named array per tensor."""
    out = {f"params.{f.name}": getattr(state.params, f.name).numpy()
           for f in dataclasses.fields(state.params)}
    for group in ("mu", "nu", "count"):
        out.update({f"{group}.{k}": v.numpy() for k, v in getattr(state, group).items()})
    out.update({k: getattr(state, k).numpy()
                for k in ("step", "grad_accum", "grad_count", "max_radii")})
    np.savez(path, **out)


REFUSALS = {
    "treedef": (lambda p, s: _rewrite(p, __treedef__=np.frombuffer(
        JAX_TREEDEF.replace("'sh'", "'shs'").encode(), np.uint8)), "treedef"),
    "missing_leaf": (lambda p, s: _rewrite(p, leaf_25=None), "missing.*leaf_25"),
    "wrong_shape": (lambda p, s: _rewrite(p, leaf_3=np.zeros((200, 1), np.float32)),
                    r"leaf_3 \(params.opacities\).*shape"),
    "wrong_dtype": (lambda p, s: _rewrite(p, leaf_5=np.ones(200, np.float32)),
                    r"leaf_5 \(params.alive\)"),
    "schedule_count": (lambda p, s: _rewrite(p, leaf_12=np.asarray(6, np.int32)), "leaf_12"),
    "old_named_layout": (_old_named_layout, "old named layout"),
}


@pytest.mark.parametrize("fault", sorted(REFUSALS))
def test_checkpoint_refusals(tmp_path, fault):
    """A wrong treedef, a missing leaf, a leaf of the wrong shape or dtype,
    a schedule count apart from the means' Adam count, and the old named
    layout: each raises, naming what differs."""
    state = _busy_state()
    path = tmp_path / "ck.npz"
    save_checkpoint(path, state)
    load_checkpoint(path, state)  # the file as written loads
    corrupt, match = REFUSALS[fault]
    corrupt(path, state)
    with pytest.raises(ValueError, match=match):
        load_checkpoint(path, state)
