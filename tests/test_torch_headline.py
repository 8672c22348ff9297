"""The port's headline harness (``tpusplat_torch.bench.headline``) against
``bench.py`` on the CPU at a tiny size: the scene (arrays and camera bit for
bit, the settled capacity equal), the step (loss rtol 1e-5, each of the five
gradients normalised by its largest magnitude at atol 1e-4, the counters
equal) and the forward-only step (the image sum rtol 1e-5) against the JAX
step built as ``bench.py`` builds it, on its XLA route and on its Pallas
route (interpret mode); the refusals of ``main()``; the differenced host
timing and the lines it prints, and the overflow check after the timed
runs."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.camera import look_at_camera as jax_look_at
from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.io.synthetic import random_scene as jax_random_scene
from tpusplat.ops.preprocess import preprocess as jax_preprocess
from tpusplat.render import render_stages as jax_render_stages
from tpusplat.train.step import merge_trainable as jax_merge, split_trainable as jax_split
from tpusplat.types import to_numpy
from tpusplat_torch.bench import headline

torch.set_num_threads(2)

TINY = dict(n=1500, w=64, h=48, sh=3, cap=8, srange=(0.02, 0.2))
FIELDS = ("means", "log_scales", "quats", "opacities", "sh", "alive")
CAMERA_FIELDS = ("view", "proj", "cam_pos", "tan_fovx", "tan_fovy")


def _jax_bench_inputs(s, use_pallas):
    """``bench.py:62-79``: the scene, the camera and the settled config."""
    params = jax_random_scene(s["n"], seed=0, sh_degree=s["sh"], scale_range=s["srange"],
                              extent=4.0)
    cam = jax_look_at([0.0, 0.5, 9.0], [0.0, 0.0, 0.0], s["w"], s["h"], fov_deg=60.0)
    cfg = JaxConfig(sh_degree=s["sh"], capacity_mult=s["cap"], use_pallas=use_pallas,
                    max_per_tile=4096, tile_chunk=64, tight_radius=True).with_env_overrides()
    needed = int(jax.jit(lambda p: jnp.sum(jax_preprocess(p, cam, cfg).ntiles))(params))
    return params, cam, dataclasses.replace(cfg, capacity=int(needed * 1.05))


@pytest.fixture(scope="module")
def port_inputs():
    return headline.scene(TINY, "cpu")


def test_scene_matches_bench_py(port_inputs):
    params, cam, cfg = port_inputs
    jparams, jcam, jcfg = _jax_bench_inputs(TINY, use_pallas=False)
    ref = to_numpy(jparams)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(params, f).numpy(), getattr(ref, f), err_msg=f)
    jc = to_numpy(jcam)
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(cam, f)), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    assert (cam.width, cam.height) == (jc.width, jc.height)
    n = TINY["n"]
    assert cfg.capacity == jcfg.capacity
    assert cfg.instance_capacity(n) == jcfg.instance_capacity(n)
    assert cfg.tight_radius and cfg.max_per_tile == 4096 and cfg.sh_degree == TINY["sh"]


def test_scene_takes_env_overrides(monkeypatch):
    """The TPUSPLAT_* variables reach the harness's config before the probe,
    as in bench.py:66-70."""
    small = dict(TINY, n=300)
    monkeypatch.setenv("TPUSPLAT_MAX_PER_TILE", "2048")
    monkeypatch.setenv("TPUSPLAT_SH_DEGREE", "1")
    cfg = headline.scene(small, "cpu")[2]
    assert (cfg.max_per_tile, cfg.sh_degree) == (2048, 1)


def _jax_steps(params, cam, cfg):
    """``bench.py:85-98``'s two steps, each also returning the loss and the
    gradients for the comparison."""
    trainable, alive = jax_split(params)
    target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)

    def loss_fn(tr):
        img, aux = jax_render_stages(jax_merge(tr, alive), cam, cfg)
        return jnp.mean((img - target) ** 2), aux

    @jax.jit
    def step(tr):
        (l, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(tr)
        return jnp.sum(g["means"]), aux["num_instances"], aux["capacity_overflow"], l, g

    @jax.jit
    def fwd(tr):
        img, aux = jax_render_stages(jax_merge(tr, alive), cam, cfg)
        return jnp.sum(img), aux["num_instances"], aux["capacity_overflow"]

    return step(trainable), fwd(trainable)


@pytest.fixture(scope="module", params=["xla", "pallas"])
def jax_reference(request):
    params, cam, cfg = _jax_bench_inputs(TINY, use_pallas=request.param == "pallas")
    return _jax_steps(params, cam, cfg)


def test_step_matches_bench_py(port_inputs, jax_reference):
    params, cam, cfg = port_inputs
    (j_sum, j_inst, j_ovf, j_loss, j_grads), _ = jax_reference
    trainable, alive = headline.split_trainable(params)
    loss, grads, aux = headline.loss_and_grads(trainable, alive, cam, cfg)
    assert float(loss) > 0.0  # the image is not black
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    errs = {}
    for f in grads:
        a = np.asarray(j_grads[f], np.float64)
        b = grads[f].numpy().astype(np.float64)
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4, err_msg=f)
        errs[f] = float(np.abs(b - a).max() / scale)
    print(f"loss rel {abs(float(loss) - float(j_loss)) / float(j_loss):.2e}, normalised "
          f"gradient errors {errs}, instances {int(aux['num_instances'])}")
    assert int(aux["num_instances"]) == int(j_inst) > 0
    assert int(aux["capacity_overflow"]) == int(j_ovf) == 0
    out = headline.step(trainable, alive, cam, cfg)
    np.testing.assert_allclose(float(out[0]), float(grads["means"].sum()), rtol=1e-6,
                               atol=1e-9)
    scale = float(np.abs(np.asarray(j_grads["means"])).sum())
    assert abs(float(out[0]) - float(j_sum)) <= 1e-4 * scale
    assert (int(out[1]), int(out[2])) == (int(j_inst), int(j_ovf))


def test_forward_step_matches_bench_py(port_inputs, jax_reference):
    params, cam, cfg = port_inputs
    _, (j_sum, j_inst, j_ovf) = jax_reference
    out = headline.forward_step(*headline.split_trainable(params), cam, cfg)
    np.testing.assert_allclose(float(out[0]), float(j_sum), rtol=1e-5)
    print(f"image sum rel {abs(float(out[0]) - float(j_sum)) / abs(float(j_sum)):.2e}")
    assert (int(out[1]), int(out[2])) == (int(j_inst), int(j_ovf))


@pytest.mark.parametrize("env,code,says", [
    ({}, 1, "no CUDA device"),
    ({"BENCH_XLA": "1"}, 2, "BENCH_XLA=1 is not ported"),
    ({"BENCH_CONFIG": "garden2"}, 2, "unknown BENCH_CONFIG"),
])
def test_main_refusals(monkeypatch, capsys, env, code, says):
    if code == 1 and torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the harness would run")
    for k in ("BENCH_XLA", "BENCH_CONFIG"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert headline.main() == code
    out = capsys.readouterr()
    assert says in out.err and out.out == ""


def test_differenced_time(monkeypatch):
    """(t_big - t_small) / iters over runs of max(1, iters // 4) and
    iters + max(1, iters // 4) calls, each ended by a host read: on a clock
    that a call moves by one second, exactly 1000 ms a call."""
    clock = [0.0]

    def fn():
        clock[0] += 1.0
        return (torch.tensor(1.0),)

    monkeypatch.setattr(headline.time, "perf_counter", lambda: clock[0])
    assert headline.differenced_ms(fn, 5) == 1000.0
    assert clock[0] == 1 + 6
    assert headline.differenced_ms(fn, 2) == 1000.0
    assert clock[0] == 7 + 1 + 3


def test_harness_lines_on_the_cpu(port_inputs, capsys):
    params, cam, cfg = port_inputs
    # named garden, so the viewer line is printed too
    lines = headline.run("garden", "cpu", iters=4, inputs=port_inputs)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == lines
    modes = [ln.get("mode") for ln in lines]
    # the step's detail, the viewer's detail and line, the headline (no
    # strip line off the card)
    assert modes == ["fwd+bwd", "viewer", None, None]
    step_detail, viewer_detail, viewer, head = lines
    for d in (step_detail, viewer_detail):
        assert d["clock"] == "host" and d["event_clock"] == "host"
        assert d["host_ms"] > 0 and d["event_ms"] > 0
        assert d["num_instances"] > 0 and d["capacity"] == cfg.instance_capacity(TINY["n"])
        assert d["device"] == {"kind": "cpu"} and d["peak_mem_bytes"] is None
    w, h, n = TINY["w"], TINY["h"], TINY["n"]
    assert list(head) == ["device", "metric", "value", "unit", "vs_baseline"]
    assert head["metric"] == f"fwd+bwd Mpix/s/chip (garden: {n} gaussians @ {w}x{h})"
    assert head["unit"] == "Mpix/s"
    mpix = w * h / 1e6 / (step_detail["host_ms"] * 1e-3)
    assert head["value"] == round(mpix, 2)
    assert head["vs_baseline"] == round(mpix / 62.2, 3)
    assert viewer["metric"] == f"VIEWER fwd-only Mpix/s/chip (garden: {n} gaussians @ {w}x{h})"

    fwd = headline.run(TINY, "cpu", iters=2, fwd_only=True, inputs=port_inputs)
    assert [ln.get("mode") for ln in fwd] == ["fwd", None]
    assert fwd[-1]["metric"].startswith("fwd Mpix/s/chip") and fwd[0]["host_ms"] > 0


def test_overflow_after_the_timed_runs_raises(port_inputs):
    params, cam, cfg = port_inputs
    short = dataclasses.replace(cfg, capacity=1024)  # below the instances
    with pytest.raises(AssertionError, match="capacity overflow"):
        headline.run(TINY, "cpu", iters=1, fwd_only=True, inputs=(params, cam, short))


def test_profile_window_over_the_step(port_inputs):
    """The profiler window that reads the headline step's idle share on the
    card, rehearsed on the CPU: the trace holds no device activity, and the
    result says so."""
    from tpusplat_torch.bench.profile_detail import profile_window

    params, cam, cfg = port_inputs
    trainable, alive = headline.split_trainable(params)
    calls = []

    def one():
        calls.append(headline.step(trainable, alive, cam, cfg))

    win = profile_window(one, "cpu", steps=2)
    assert len(calls) == 2 and all(int(c[2]) == 0 for c in calls)
    assert win["steps"] == 2 and win["window_ms"] > 0
    assert win["profiler_device_events"] == 0 and win["idle_share"] is None
