"""The port's compiled steps (``tpusplat_torch/compiled.py``) on the CPU, where
the same objects run without a graph: the compiled ``train_step`` through a
densify round copied in and a forced regrow against the JAX package's jitted
``train_step`` (XLA route) and against the eager port step (bit for bit);
the compiled ``render_stages`` against the JAX package's jitted one; the
cache's keys and its two entries; what a caller may hold past the next
call (copies out, the donated state in place, no copy of an unchanged
input); the compiled render its caller owns (``render_auto``, a session)
and frees; and no host read of a tensor's value inside a compiled body."""

import dataclasses
import gc
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.render import render_stages as jax_render_stages
from tpusplat.train import checkpoint as jax_checkpoint
from tpusplat.train import densify as jax_densify
from tpusplat.train import step as jstep
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.compiled import compile_step, flatten
from tpusplat_torch.config import regrow
from tpusplat_torch.ops import rasterize, segment_reduce
from tpusplat_torch.render import compile_render, render_auto, render_stages
from tpusplat_torch.train import checkpoint, prng
from tpusplat_torch.train import densify as tdensify
from tpusplat_torch.train import step as tstep

torch.set_num_threads(2)

N, W, H, SH = 1500, 64, 48, 3
ALIVE = 1100  # the rest are free slots for densify
FIELDS = tstep.TRAINABLE


def _jax_inputs():
    params = jax_random_scene(N, seed=3, sh_degree=SH, scale_range=(0.02, 0.2), extent=4.0)
    params = dataclasses.replace(params, alive=jnp.arange(N) < ALIVE)
    cam = jax_look_at([0.3, 0.5, 8.0], [0, 0, 0], W, H, fov_deg=60.0)
    cfg = JaxConfig(sh_degree=SH, max_per_tile=1024, tile_chunk=16, gauss_chunk=32,
                    use_pallas=False)
    target = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    return params, cam, cfg, target


def _port(params, cam):
    p, c = to_numpy(params), to_numpy(cam)
    tp = convert.params_from_numpy(p.means, p.log_scales, p.quats, p.opacities, p.sh,
                                   p.alive, device="cpu")
    tc = convert.camera_from_numpy(c.view, c.proj, c.cam_pos, c.tan_fovx, c.tan_fovy,
                                   c.width, c.height, device="cpu")
    return tp, tc


def _port_cfg(cfg):
    return convert.config_from_fields(dataclasses.asdict(cfg))


def _state_leaves(state):
    return checkpoint.state_tensors(state)


def _n_leaves(state):
    leaves = []
    flatten(state, leaves)
    return len(leaves)


def _assert_states_equal(a, b):
    for k, t in _state_leaves(a).items():
        np.testing.assert_array_equal(t.numpy(), _state_leaves(b)[k].numpy(), err_msg=k)


@pytest.fixture(scope="module")
def inputs():
    return _jax_inputs()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The bit-for-bit comparisons here run on one CPU thread: the CPU
    libraries split a reduction by the threads they get, and a loaded
    machine (the JAX step compiling beside the first eager step, other
    test processes) can give one call fewer than the next."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_compiled_train_step_through_densify_and_regrow_matches_jax(inputs, tmp_path):
    """Five applied steps: two, a densify round (the JAX package's, moved in
    through its checkpoint file, so the compiled step copies a foreign state
    in), an overflowed step at a capacity below need (the state unchanged),
    then two at the regrown capacity, a new key (the JAX step keeps its
    first capacity, which no step overflows). Each step's loss against
    the jitted JAX step at rtol 1e-4, the parameters at the end at atol two
    learning-rate steps a step (``test_torch_train.py``'s bounds); the eager
    port step in lockstep, bit for bit."""
    params, cam, jcfg, target = inputs
    kw = dict(scene_extent=4.0, means_lr_max_steps=20)
    jopt, topt = jstep.make_optimizer(**kw), tstep.make_optimizer(**kw)
    tp, tc = _port(params, cam)
    cfg = _port_cfg(jcfg)
    tgt = torch.from_numpy(target)
    step = tstep.compile_train_step()

    js = jstep.create_train_state(params, jopt)
    eager = tstep.create_train_state(tp)
    state = tstep.create_train_state(tp)

    def both(cfg_now):
        nonlocal js, eager, state
        # The JAX step keeps its first capacity: without overflow the
        # capacity changes no result.
        js, jm = jstep.train_step(js, cam, jnp.asarray(target), jcfg, jopt)
        eager, em = tstep.train_step(eager, tc, tgt, cfg_now, topt)
        state, m = step(state, tc, tgt, cfg_now, topt)
        assert int(m["capacity_overflow"]) == int(jm["capacity_overflow"]) == 0
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        assert float(m["loss"]) == float(em["loss"])
        _assert_states_equal(state, eager)

    for _ in range(2):
        both(cfg)

    # densify: the JAX round, its state moved into the port by file
    js = jax_densify.densify_and_prune(js, jax.random.PRNGKey(5),
                                       jax_densify.DensifyConfig(grad_threshold=1e-7), 4.0)
    path = str(tmp_path / "densified.npz")
    jax_checkpoint.save_checkpoint(path, js)
    moved = checkpoint.load_checkpoint(path, state)
    assert int(moved.params.alive.sum()) > ALIVE  # the round granted slots
    eager = checkpoint.load_checkpoint(path, state)
    copies = step.stats["copies_in"]
    state = moved
    both(cfg)
    assert step.stats["copies_in"] - copies == _n_leaves(moved)

    # a forced regrow: a capacity below need overflows, the state unchanged
    small = dataclasses.replace(cfg, capacity=1024)
    before = {k: t.clone() for k, t in _state_leaves(state).items()}
    state, m = step(state, tc, tgt, small, topt)
    assert int(m["capacity_overflow"]) > 0
    for k, t in _state_leaves(state).items():
        np.testing.assert_array_equal(t.numpy(), before[k].numpy(), err_msg=k)
    grown, changes = regrow(small, m, N)
    assert changes is not None and grown.capacity > small.capacity
    for _ in range(2):
        both(grown)
    assert step.stats["captures"] == 3 and len(step) == 2  # cfg, small, grown: two kept

    assert int(state.step) == int(js.step) == 5
    lrs = dict(means=topt.means_lr * topt.scene_extent, log_scales=topt.scales_lr,
               quats=topt.quats_lr, opacities=topt.opacities_lr, sh=topt.sh_lr)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(state.params, f).numpy(),
                                   np.asarray(getattr(js.params, f)),
                                   atol=2 * lrs[f] * 5, err_msg=f)
    np.testing.assert_array_equal(state.params.alive.numpy(), np.asarray(js.params.alive))


def test_compiled_render_stages_matches_jax(inputs):
    """The compiled render at ``test_torch_render.py``'s bounds against the
    jitted JAX render, on a first call (the capture) and a replay at another
    camera; the counters equal."""
    params, _, jcfg, _ = inputs
    render = compile_step(render_stages, static_argnames=("cfg",))
    for eye in ([0.3, 0.5, 8.0], [-1.0, 0.2, 7.0]):
        jcam = jax_look_at(eye, [0, 0, 0], W, H, fov_deg=60.0)
        img_j, aux_j = jax_render_stages(params, jcam, jcfg)
        tp, tc = _port(params, jcam)
        img, aux = render(tp, tc, _port_cfg(jcfg))
        np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(aux["transmittance"].numpy(),
                                   np.asarray(aux_j["transmittance"]), atol=3e-5)
        for k in ("num_instances", "capacity_overflow", "tile_overflow"):
            assert int(aux[k]) == int(aux_j[k]), k
    assert render.stats["captures"] == 1 and render.stats["replays"] == 2


def _tiny(n=300, w=32, h=24, seed=2):
    from tpusplat_torch import RenderConfig, look_at_camera, random_scene

    params = random_scene(n, seed=seed, sh_degree=1, scale_range=(0.05, 0.25), device="cpu")
    cam = look_at_camera([0.5, 0.3, 6.0], [0, 0, 0], w, h, fov_deg=60.0, device="cpu")
    return params, cam, RenderConfig(sh_degree=1, max_per_tile=512, tile_chunk=4)


def _variant(change, k):
    params, cam, cfg = _tiny()
    if change == "cfg":
        return params, cam, dataclasses.replace(cfg, capacity=2048 * (k + 1))
    if change == "n":
        return _tiny(n=300 - 50 * k)[0], cam, cfg
    return params, _tiny(w=32 + 8 * k)[1], cfg  # the frame size


@pytest.mark.parametrize("change", ["cfg", "n", "frame"])
def test_cache_keys_and_two_entries(change):
    """The same static arguments and shapes reuse one entry, whatever tensors
    hold them; a new cfg, N or frame size captures a new one; the two most
    recently used are kept, and an evicted key captures again."""
    render = compile_step(render_stages, static_argnames=("cfg",))
    first = _variant(change, 0)
    with torch.no_grad():
        render(*first)
        render(*_variant(change, 0))  # new tensors, the same key
        assert render.stats["captures"] == 1 and render.stats["replays"] == 2
        for k in (1, 2):
            render(*_variant(change, k))
            assert render.stats["captures"] == 1 + k and len(render) == min(2, 1 + k)
        assert render.stats["evictions"] == 1
        img, _ = render(*first)
        assert render.stats["captures"] == 4 and len(render) == 2
        np.testing.assert_array_equal(img.numpy(), render_stages(*first)[0].numpy())


def test_cache_key_holds_the_grad_mode():
    render = compile_step(render_stages, static_argnames=("cfg",))
    params, cam, cfg = _tiny()
    with torch.no_grad():
        render(params, cam, cfg)
    render(params, cam, cfg)
    assert render.stats["captures"] == 2 and len(render) == 2


def test_outputs_outlive_the_next_call_and_the_state_is_donated(inputs):
    """Step k's image and metrics are unchanged by step k+1 (copied out); the
    state a step returns is its buffers, updated in place by the next step
    given it (the old state object sees the new values), which copies
    nothing in; an unchanged input is not copied, a written one is; a state
    from outside is copied in."""
    params, cam, jcfg, target = inputs
    tp, tc = _port(params, cam)
    cfg = _port_cfg(jcfg)
    tc2 = _port(params, jax_look_at([-1.0, 0.2, 7.0], [0, 0, 0], W, H, fov_deg=60.0))[1]
    render = compile_step(render_stages, static_argnames=("cfg",))
    with torch.no_grad():
        img1, aux1 = render(tp, tc, cfg)
        keep = img1.clone(), aux1["transmittance"].clone()
        img2, _ = render(tp, tc2, cfg)
    assert not torch.equal(img1, img2)
    assert torch.equal(img1, keep[0]) and torch.equal(aux1["transmittance"], keep[1])

    tgt = torch.from_numpy(target)
    opt = tstep.make_optimizer(scene_extent=4.0)
    step = tstep.compile_train_step()
    s1, m1 = step(tstep.create_train_state(tp), tc, tgt, cfg, opt)
    loss1 = m1["loss"].clone()
    copies = step.stats["copies_in"]
    s1_means = s1.params.means.clone()
    s2, m2 = step(s1, tc, tgt, cfg, opt)
    assert step.stats["copies_in"] == copies  # the state is the buffers; tc, tgt unchanged
    assert torch.equal(m1["loss"], loss1) and not torch.equal(m2["loss"], m1["loss"])
    for a, b in zip(_state_leaves(s1).values(), _state_leaves(s2).values()):
        assert a.data_ptr() == b.data_ptr()
    assert not torch.equal(s2.params.means, s1_means)  # donated: updated in place
    assert torch.equal(s1.params.means, s2.params.means)

    tgt.mul_(1.0)  # a write, though the values stay: copied again
    step(s2, tc, tgt, cfg, opt)
    assert step.stats["copies_in"] == copies + 1
    outside = tstep.create_train_state(tp)
    step(outside, tc, tgt, cfg, opt)
    assert step.stats["copies_in"] == copies + 1 + _n_leaves(outside)

    # The buffers a replay wrote are written inputs for another compiled step.
    with torch.no_grad():
        render(s2.params, tc, cfg)
    before = render.stats["copies_in"]
    step(s2, tc, tgt, cfg, opt)
    with torch.no_grad():
        img, _ = render(s2.params, tc, cfg)
    assert render.stats["copies_in"] - before == 5  # the five trained fields; alive unchanged
    np.testing.assert_array_equal(img.numpy(), render_stages(s2.params, tc, cfg)[0].numpy())


def test_render_auto_replays_the_callers_compiled_render():
    """``render_auto`` replays the compiled render its caller keeps (one
    capture, then a replay a frame, the frames exact); without one it makes
    its own for the call, and the caller's is untouched."""
    params, cam, cfg = _tiny()
    render = compile_render()
    with torch.no_grad():
        want = render_stages(params, cam, cfg)[0]
        for _ in range(2):
            img, _, got_cfg = render_auto(params, cam, cfg, compiled=render)
            np.testing.assert_array_equal(img.numpy(), want.numpy())
        img, _, _ = render_auto(params, cam, cfg)
    assert got_cfg is cfg
    assert render.stats["captures"] == 1 and render.stats["replays"] == 2
    np.testing.assert_array_equal(img.numpy(), want.numpy())


def test_a_dropped_step_frees_its_buffers_at_once():
    """An entry holds no reference back to its step, so a step its owner
    lets go of frees its static buffers (and on the card its graphs and
    pools) at once, not when the garbage collector next runs."""
    params, cam, cfg = _tiny()
    render = compile_render()
    with torch.no_grad():
        render(params, cam, cfg)
    (entry,) = render._entries.values()
    buffer = weakref.ref(entry.inputs[0])
    del entry
    gc.disable()
    try:
        del render
        assert buffer() is None
    finally:
        gc.enable()


def test_the_session_owns_its_render_and_a_resize_captures_anew():
    """Each session keeps its own compiled render: its frames replay it, a
    resize captures anew at the next frame, and another session shares
    nothing with it."""
    from tpusplat_torch.session import Session, SessionConfig

    params, _, cfg = _tiny()
    sessions = [Session(SessionConfig(width=32, height=24, fov=60.0, render=cfg),
                        params=params, device="cpu") for _ in range(2)]
    a, b = sessions
    for s in sessions:
        s.position = np.array([0.0, 0.3, 6.0])
        s.initialize()
    img, _ = a.draw()
    a.draw()
    assert a._render is not b._render and len(b._render) == 0
    assert a._render.stats["captures"] == 1 and a._render.stats["replays"] == 2
    a.resize(40, 24)
    img_r, _ = a.draw()
    assert img_r.shape == (24, 40, 3) and a._render.stats["captures"] == 2
    np.testing.assert_array_equal(b.draw()[0].numpy(), img.numpy())


def _called_from(code) -> bool:
    frame = sys._getframe(1)
    while frame is not None and frame.f_code is not code:
        frame = frame.f_back
    return frame is not None


class _NoHostReads(TorchDispatchMode):
    """Refuses the aten ops that read a tensor's value on the host; an index
    by a boolean mask, whose kernel reads the mask's count of True
    (``nonzero``) below this mode, where the mode does not see it, but for
    the plain segment reduce's mask (``_index_add``), which runs only on the
    CPU, where the segment-reduce kernel is absent; and a tensor made from
    host values (``torch.tensor``), a copy from the host."""

    REFUSED = ("_local_scalar_dense", "item", "nonzero", "masked_select")
    INDEXING = ("index", "index_put", "index_put_", "_index_put_impl_")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.REFUSED:
            raise AssertionError(f"host read inside a compiled step: {func}")
        if name == "lift_fresh":
            raise AssertionError(f"copy from the host inside a compiled step: {func}")
        if name in self.INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]) and not _called_from(segment_reduce._index_add.__code__):
            raise AssertionError(f"host read inside a compiled step: {func} by a boolean mask")
        return func(*args, **(kwargs or {}))


def _refuse_tolist(monkeypatch):
    """``Tensor.tolist`` refused, but for the plain blend's batch walk, which
    reads the tile counts on the host and runs only on the CPU, where the
    forward kernel is absent."""
    tolist = torch.Tensor.tolist

    def guarded(self):
        if sys._getframe(1).f_code is not rasterize.blend_plain.__code__:
            raise AssertionError("Tensor.tolist inside a compiled step")
        return tolist(self)

    monkeypatch.setattr(torch.Tensor, "tolist", guarded)


def test_no_host_read_inside_the_compiled_steps(inputs, monkeypatch):
    """The compiled bodies (a capture and a replay each of render_stages and
    train_step) under a dispatch mode that refuses ``_local_scalar_dense``,
    ``item``, ``nonzero``, ``masked_select``, an index by a boolean mask and
    a tensor made from host values, with ``Tensor.tolist`` refused too; and
    the mode does catch a read."""
    params, cam, jcfg, target = inputs
    tp, tc = _port(params, cam)
    cfg = _port_cfg(jcfg)
    tgt = torch.from_numpy(target)
    opt = tstep.make_optimizer(scene_extent=4.0)
    render = compile_step(render_stages, static_argnames=("cfg",))
    step = tstep.compile_train_step()
    state = tstep.create_train_state(tp)
    _refuse_tolist(monkeypatch)
    with _NoHostReads():
        for _ in range(2):
            with torch.no_grad():
                render(tp, tc, cfg)
            state, _ = step(state, tc, tgt, cfg, opt)
        with pytest.raises(AssertionError, match="host read"):
            int(state.step)
    with pytest.raises(AssertionError, match="tolist"):
        state.step.tolist()
    assert render.stats["replays"] == step.stats["replays"] == 2


def test_no_host_read_inside_the_compiled_densify_round(inputs, monkeypatch):
    """The compiled densify round, its keys tensors, under the same dispatch
    mode with ``Tensor.tolist`` refused: a capture and a replay with another
    key, each granting slots; and the mode does catch a read, an index by a
    boolean mask and a copy from the host."""
    params, cam, _, _ = inputs
    state = tstep.create_train_state(_port(params, cam)[0])
    gen = torch.Generator().manual_seed(0)
    state.grad_accum = 4e-4 * torch.rand(N, generator=gen)
    state.grad_count = torch.ones(N)
    round_ = tdensify.compile_densify()
    dcfg = tdensify.DensifyConfig()
    keys = [prng.key_tensor(k, "cpu") for k in prng.split(prng.key(0), 2)]
    _refuse_tolist(monkeypatch)
    alive = []
    with _NoHostReads():
        for k in keys:
            alive.append(round_(state, k, dcfg, 4.0).params.alive)
        with pytest.raises(AssertionError, match="host read"):
            int(alive[0].sum())
        with pytest.raises(AssertionError, match="boolean mask"):
            state.params.means[alive[0]]
        with pytest.raises(AssertionError, match="copy from the host"):
            torch.tensor(dcfg.split_scale_div)
    assert round_.stats["captures"] == 1 and round_.stats["replays"] == 2
    assert all(int(a[ALIVE:].sum()) > 0 for a in alive)  # both rounds granted slots
