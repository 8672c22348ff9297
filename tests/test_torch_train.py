"""The port's training step (tpusplat_torch/train/step.py) and trainer CLI on
the CPU against the JAX package: the hand-written Adam against optax on
identical gradients, three train_steps against the JAX train_step from the
same parameters, the overflow gate, a tiny trainer run, and the rule that
the port imports neither ``jax`` nor ``tpusplat``."""

import ast
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.train import step as jstep
from tpusplat.types import to_numpy
from tpusplat_torch import convert
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.train import step as tstep

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIELDS = tstep.TRAINABLE


def _port(params, cam):
    p, c = to_numpy(params), to_numpy(cam)
    tp = convert.params_from_numpy(p.means, p.log_scales, p.quats, p.opacities, p.sh,
                                   p.alive, device="cpu")
    tc = convert.camera_from_numpy(c.view, c.proj, c.cam_pos, c.tan_fovx, c.tan_fovy,
                                   c.width, c.height, device="cpu")
    return tp, tc


def _jax_adam_state(opt_state, name):
    return opt_state.inner_states[name].inner_state[0]


@pytest.mark.parametrize("count", [0, 1, 2, 3, 7, 100])
def test_means_schedule_matches_optax(count):
    kw = dict(means_lr_max_steps=5, scene_extent=2.5)
    sched = optax.exponential_decay(init_value=1.6e-4 * 2.5, transition_steps=5,
                                    decay_rate=1.6e-6 / 1.6e-4, end_value=1.6e-6 * 2.5)
    got = float(tstep.make_optimizer(**kw).learning_rate("means", torch.tensor(count)))
    np.testing.assert_allclose(got, float(sched(jnp.int32(count))), rtol=1e-6)


def test_adam_matches_optax_on_identical_grads():
    """Five steps, the means schedule reaching its end value (max steps 3),
    on the same gradients: the updates and moments at rtol 1e-6."""
    rng = np.random.default_rng(0)
    n = 64
    shapes = dict(means=(n, 3), log_scales=(n, 3), quats=(n, 4), opacities=(n,),
                  sh=(n, 16, 3))
    kw = dict(means_lr_max_steps=3, scene_extent=3.0)
    jopt = jstep.make_optimizer(**kw)
    topt = tstep.make_optimizer(**kw)
    params = {k: jnp.asarray(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    jstate = jopt.init(params)
    zeros = {k: torch.zeros(s) for k, s in shapes.items()}
    mu = {k: torch.zeros(s) for k, s in shapes.items()}
    nu = {k: torch.zeros(s) for k, s in shapes.items()}
    count = {k: torch.zeros((), dtype=torch.int32) for k in shapes}
    for _ in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32) * rng.uniform(1e-4, 1)
                 for k, s in shapes.items()}
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                      params)
        # Zero parameters: the new parameters are the updates themselves.
        upd, mu, nu, count = tstep.adam_update(
            topt, zeros, {k: torch.from_numpy(v) for k, v in grads.items()}, mu, nu, count)
        for k in shapes:
            js = _jax_adam_state(jstate, k)
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(updates[k]), rtol=1e-6,
                                       atol=1e-12, err_msg=k)
            np.testing.assert_allclose(mu[k].numpy(), np.asarray(js.mu[k]), rtol=1e-6,
                                       atol=1e-12, err_msg=k)
            np.testing.assert_allclose(nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-6,
                                       atol=1e-12, err_msg=k)
            assert int(count[k]) == int(js.count)


def _scene(n=400, w=64, h=48, seed=6):
    params = jax_random_scene(n, seed=seed, sh_degree=1, scale_range=(0.05, 0.3))
    cam = jax_look_at([0.3, 0.2, 6.0], [0, 0, 0], w, h, fov_deg=60.0)
    return params, cam


def test_three_train_steps_match_jax():
    """Loss per step at rtol 1e-4; parameters at atol 2 lr steps, since
    eps 1e-15 makes Adam close to sign(g) and gradients near zero may flip;
    the densification statistics of the first step at atol 1e-6."""
    params, cam = _scene()
    cfg = JaxConfig(sh_degree=1, max_per_tile=512, tile_chunk=4, gauss_chunk=16)
    rng = np.random.default_rng(0)
    target = rng.uniform(0, 1, (cam.height, cam.width, 3)).astype(np.float32)
    kw = dict(scene_extent=2.0, means_lr_max_steps=10)
    jopt, topt = jstep.make_optimizer(**kw), tstep.make_optimizer(**kw)

    js = jstep.create_train_state(params, jopt)
    tp, tc = _port(params, cam)
    ts = tstep.create_train_state(tp)
    tcfg = convert.config_from_fields(dataclasses.asdict(cfg))
    steps = 3
    for i in range(steps):
        js, jm = jstep.train_step(js, cam, jnp.asarray(target), cfg, jopt)
        ts, tm = tstep.train_step(ts, tc, torch.from_numpy(target), tcfg, topt)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        assert int(tm["capacity_overflow"]) == int(jm["capacity_overflow"]) == 0
        if i == 0:
            for f in ("grad_accum", "grad_count", "max_radii"):
                np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                           atol=1e-6, rtol=1e-4, err_msg=f)
    assert int(ts.step) == int(js.step) == steps
    lrs = dict(means=topt.means_lr * topt.scene_extent, log_scales=topt.scales_lr,
               quats=topt.quats_lr, opacities=topt.opacities_lr, sh=topt.sh_lr)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ts.params, f).numpy(),
                                   np.asarray(getattr(js.params, f)),
                                   atol=2 * lrs[f] * steps, err_msg=f)


def test_train_step_overflow_is_noop():
    """tests/test_regrow.py::test_train_step_overflow_is_noop for the port:
    an overflowed step leaves every tensor of the state bit-identical; the
    retry at a grown capacity applies a real step."""
    params, cam = _scene(n=600)
    params = dataclasses.replace(params, log_scales=params.log_scales + 0.7)
    tp, tc = _port(params, cam)
    target = torch.zeros((cam.height, cam.width, 3))
    opt = tstep.make_optimizer()
    tiny = RenderConfig(sh_degree=1, capacity=1024, max_per_tile=2048, tile_chunk=4,
                        gauss_chunk=16)
    state0 = tstep.create_train_state(tp)
    # Nonzero moments and statistics, so that "unchanged" is not "still zero".
    state0.mu = {k: torch.full_like(v, 0.5) for k, v in state0.mu.items()}
    state0.grad_accum = torch.rand(600)
    state1, metrics = tstep.train_step(state0, tc, target, tiny, opt)
    assert int(metrics["capacity_overflow"]) > 0  # engineered overflow
    assert int(state1.step) == 0
    for f in FIELDS:
        for a, b in ((getattr(state1.params, f), getattr(state0.params, f)),
                     (state1.mu[f], state0.mu[f]), (state1.nu[f], state0.nu[f]),
                     (state1.count[f], state0.count[f])):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    for f in ("grad_accum", "grad_count", "max_radii"):
        np.testing.assert_array_equal(getattr(state1, f).numpy(), getattr(state0, f).numpy())

    grown = dataclasses.replace(tiny, capacity=64 * 1024)
    state2, metrics2 = tstep.train_step(state1, tc, target, grown, opt)
    assert int(metrics2["capacity_overflow"]) == 0
    assert int(state2.step) == 1 and int(state2.count["means"]) == 1
    assert not torch.equal(state2.params.means, state0.params.means)


def test_trainer_cli_tiny_run_on_cpu(tmp_path, capsys):
    from tpusplat_torch import load_ply, trainer

    out = tmp_path / "t.ply"
    summary = trainer.main(["--synthetic", "--steps", "6", "--n-init", "300", "--width", "32",
                            "--height", "32", "--cameras", "2", "--sh-degree", "1",
                            "--log-every", "3", "--densify-every", "3", "--eval-every", "3",
                            "--device", "cpu", "--out", str(out)])
    lines = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("{")]
    assert [s for s, _ in summary["losses"]] == [3, 6]
    assert all(np.isfinite(v) for _, v in summary["losses"])
    assert summary["evals"][-1]["final"] and summary["step"] >= 6
    assert any("psnr" in ln for ln in lines)
    assert load_ply(out, device="cpu").num_gaussians > 0


@pytest.mark.parametrize("flag", [["--mesh", "2x4"], ["--overlap"], ["--xla"],
                                  ["--holdout", "1"], ["--ckpt", "c"]])
def test_trainer_rejects_unported_flags(flag, capsys, monkeypatch):
    """--xla, which is not ported; --mesh and --overlap where they cannot
    run: --mesh without a rank in the environment (it is launched by
    torchrun), --overlap without --mesh; and, before any data is read,
    --holdout 1 and a --ckpt that is not .npz."""
    from tpusplat_torch import trainer

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        trainer.main(["--device", "cpu", *flag])
    assert e.value.code == 2
    want = {"--mesh": "torchrun", "--overlap": "needs --mesh", "--holdout": "must be >= 2",
            "--ckpt": ".npz"}.get(flag[0], "not ported")
    assert want in capsys.readouterr().err


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_tpusplat():
    files = sorted((REPO / "tpusplat_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "optax", "tpusplat")]
    assert not bad, bad
