"""The port's densify round against the benchmark's plain round
(``splatbench/reference_densify.py``), on the CPU: with the split draws
handed in, the same decisions and fields; each fault the benchmark's check
of the round is set to catch, planted in the port, caught by the limits of
``splatbench/limits/garden-train-grow.json``; the round's ``densify`` stamp
and counters read back through a compiled round; the trainer's ``densify``
log line carrying them."""

import dataclasses
import json
import os

import pytest
import torch

from splatbench import drive, reference, reference_densify as rd
from tpusplat_torch import trace, trainer
from tpusplat_torch.camera import look_at_camera
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.train import densify as td
from tpusplat_torch.train import prng
from tpusplat_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMITS = json.load(open(os.path.join(ROOT, "splatbench", "limits", "garden-train-grow.json")))
N, ALIVE, EXTENT = 1200, 800, 4.0


@pytest.fixture(autouse=True)
def fresh_rings(monkeypatch):
    """Fresh host rings and round counters; one thread (bit-equal runs)."""
    monkeypatch.setattr(trace, "_host", trace._HostRings())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed=3):
    """A mid-densification state: a third of the slots free, two thirds of
    the alive ones candidates (more than the free slots), log-uniform scales
    so that candidates both clone and split, a few to prune by opacity and
    by world size, random moments."""
    g = torch.Generator().manual_seed(seed)
    params = random_scene(N, seed=seed, sh_degree=1, device="cpu")
    log_scales = torch.log(torch.tensor(0.005)) + torch.rand((N, 3), generator=g) * 3.7
    log_scales[5] = torch.log(torch.tensor(0.6))  # world-size prune
    opacities = params.opacities.clone()
    opacities[7:10] = -9.0  # opacity prune
    params = dataclasses.replace(params, log_scales=log_scales, opacities=opacities,
                                 alive=torch.arange(N) < ALIVE)
    st = tstep.create_train_state(params)
    st.mu = {k: torch.randn(v.shape, generator=g) for k, v in st.mu.items()}
    st.nu = {k: torch.rand(v.shape, generator=g) for k, v in st.nu.items()}
    st.grad_accum = 6e-4 * torch.rand(N, generator=g) * params.alive
    st.grad_count = torch.ones(N) * params.alive
    st.max_radii = 5 * torch.rand(N, generator=g)
    return st


def _plain(st) -> dict:
    p = st.params
    return dict({f: getattr(p, f) for f in rd.PARAMS + ("alive",)}, mu=dict(st.mu),
                nu=dict(st.nu), **{f: getattr(st, f) for f in rd.STATS})


def _noise(seed=11):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((N, 3), generator=g), torch.randn((N, 3), generator=g)


def test_port_round_matches_the_plain_round():
    """Decisions equal (alive, granted slots, splits, prunes; free slots
    running out), every field within float32 rounding of the plain round,
    the split positions too, given the same draws."""
    st = _state()
    noise, noise2 = _noise()
    out = td.densify_and_prune(st, prng.key(0), td.DensifyConfig(), EXTENT, noise=noise,
                               noise2=noise2)
    ref = rd.densify_round(_plain(st), EXTENT, noise=noise, noise2=noise2)
    c = rd.counts(ref)
    assert c["granted"] == N - ALIVE < c["candidates"]  # the free slots ran out
    assert c["split"] > 100 and c["cloned"] > 20 and c["pruned"] >= 4, c
    got = rd.decisions(_plain(st), _plain(out))
    for k, want in (("alive", ref["state"]["alive"]), ("is_target", ref["is_target"]),
                    ("split", ref["split"]), ("pruned", ref["pruned"])):
        assert torch.equal(got[k], want), k
    for f in rd.PARAMS:
        torch.testing.assert_close(getattr(out.params, f), ref["state"][f], rtol=1e-6,
                                   atol=1e-6, msg=f)
        for m in ("mu", "nu"):
            assert torch.equal(getattr(out, m)[f], ref["state"][m][f]), (m, f)
    for f in rd.STATS:
        assert not getattr(out, f).any()
    readings = rd.compare(_plain(st), _plain(out), ref)
    assert readings["decision_mismatch"] == 0 and readings["kept_gap"] < LIMITS["kept_gap"]


def _faulted_round(fault):
    """The port's round from its own key's draws, with ``fault`` planted."""
    st = _state()
    dcfg, key = td.DensifyConfig(), prng.key(5)
    if fault == "clone_only":
        dcfg = dataclasses.replace(dcfg, percent_dense=1e9)
    noise = (torch.zeros(N, 3),) * 2 if fault == "noise_zero" else (None, None)
    out = td.densify_and_prune(st, key, dcfg, EXTENT, noise=noise[0], noise2=noise[1])
    if fault == "moments_kept":
        out = dataclasses.replace(out, mu=st.mu, nu=st.nu)
    elif fault == "unchanged":
        out = st
    g = torch.Generator().manual_seed(0)
    return rd.compare(_plain(st), _plain(out), rd.densify_round(_plain(st), EXTENT, generator=g))


def _failed(readings):
    return sorted(k for k, v in readings.items() if not v <= LIMITS[k])


def test_the_sound_round_passes_every_limit():
    """The port drawing its own splits from a key: the noise read by its
    statistics alone, every reading inside the cell's limits."""
    assert _failed(_faulted_round(None)) == []


@pytest.mark.parametrize("fault", ["unchanged", "clone_only", "moments_kept", "noise_zero"])
def test_each_fault_of_the_round_fails_a_limit(fault):
    assert _failed(_faulted_round(fault)), fault


def _stats_after_steps(skip_stats, monkeypatch):
    """The statistics' norms after two compiled steps of the port, and the
    plain steps' (``reference_densify.step_stats``)."""
    if skip_stats:
        real = tstep.apply_gradients

        def apply_gradients(state, *a, **k):
            new, metrics = real(state, *a, **k)
            return dataclasses.replace(new, grad_accum=state.grad_accum,
                                       grad_count=state.grad_count,
                                       max_radii=state.max_radii), metrics

        monkeypatch.setattr(tstep, "apply_gradients", apply_gradients)
    params = random_scene(300, seed=2, sh_degree=1, scale_range=(0.02, 0.2), device="cpu")
    params = dataclasses.replace(params, alive=torch.arange(300) < 200)
    conf = dict(sh_degree=1, tight_radius=True)
    cfg = RenderConfig(sh_degree=1, max_per_tile=256, tile_chunk=4, tight_radius=True)
    cam = look_at_camera([0.0, 0.5, 6.0], [0.0, 0.0, 0.0], 48, 32, fov_deg=60.0, device="cpu")
    mats = dict(view=cam.view.double().numpy(), proj=cam.proj.double().numpy(),
                cam_pos=cam.cam_pos.double().numpy(), tan_fovx=float(cam.tan_fovx),
                tan_fovy=float(cam.tan_fovy), width=48, height=32)
    target = torch.rand((32, 48, 3), generator=torch.Generator().manual_seed(1))
    opt = tstep.make_optimizer(scene_extent=EXTENT)
    step = tstep.compile_train_step()
    st = tstep.create_train_state(params)
    p = {f: getattr(params, f) for f in rd.PARAMS + ("alive",)}
    adam, stats = reference.adam_state(p), None
    for _ in range(2):
        st, _ = step(st, cam, target, cfg, opt)
        ref_cam = reference.camera(mats, torch.float32, "cpu")
        _, grads, _ = reference.train_step(p, ref_cam, target, conf, 0.2)
        stats = rd.accumulate(stats, rd.step_stats(p, ref_cam, grads, conf))
        p = reference.adam(p, grads, adam, EXTENT)
    prog = {f: reference.norm(getattr(st, f)) for f in rd.STATS}
    return drive.leaf_gap(prog, {f: reference.norm(stats[f]) for f in rd.STATS})[0]


@pytest.mark.parametrize("skip_stats", [False, True], ids=["sound", "no_stats"])
def test_statistics_against_the_plain_steps(skip_stats, monkeypatch):
    """The densify statistics of the port's compiled steps against the
    plain steps': within ``stats_gap``'s limit, and outside it where the
    step never accumulates them."""
    gap = _stats_after_steps(skip_stats, monkeypatch)
    assert (gap > LIMITS["stats_gap"]) == skip_stats, gap


def test_compiled_round_stamps_and_counts():
    """A compiled round on the CPU route, captured then replayed: each call
    stamps ``densify`` then ``end`` under the round's tag, and writes one
    row of counters equal to the plain round's counts."""
    st = _state()
    round_ = td.compile_densify()
    keys = prng.split(prng.key(1), 2)
    want = []
    for k in keys:
        out = round_(st, prng.key_tensor(k, "cpu"), td.DensifyConfig(), EXTENT)
        noise = prng.normal(k, (N, 3), "cpu")
        noise2 = prng.normal(prng.fold_in(k, 1), (N, 3), "cpu")
        ref = rd.densify_round(_plain(st), EXTENT, noise=noise, noise2=noise2)
        assert torch.equal(out.params.alive, ref["state"]["alive"])
        want.append(rd.counts(ref))
    units = trace.read("cpu").units(round_.tag)
    assert [[name for name, _ in u.marks] for u in units] == [["densify", "end"]] * 2
    assert list(units[0].stage_ms()) == ["densify"]
    rows = trace.rounds("cpu")
    assert [r["round"] for r in rows] == [0, 1]
    assert [{k: r[k] for k in want[0]} for r in rows] == want
    assert rows[0]["split"] > 0 and rows[0]["cloned"] > 0


def test_counters_keep_the_latest_rounds_and_skip_warmups(monkeypatch):
    """The counter block is a ring: the latest ``ROUND_RING`` rounds, oldest
    first; nothing is written while tracing is off or inside ``quiet``."""
    monkeypatch.setattr(trace, "ROUND_RING", 3)
    cpu = torch.device("cpu")
    for i in range(5):
        trace.count_round(cpu, **{k: torch.tensor(i) for k in trace.ROUND_COUNTS})
    with trace.quiet():
        trace.count_round(cpu, **{k: torch.tensor(9) for k in trace.ROUND_COUNTS})
    monkeypatch.setattr(trace, "enabled", False)
    trace.count_round(cpu, **{k: torch.tensor(9) for k in trace.ROUND_COUNTS})
    rows = trace.rounds(cpu)
    assert [(r["round"], r["alive"]) for r in rows] == [(2, 2), (3, 3), (4, 4)]
    assert trace.rounds(cpu, last=1) == rows[-1:]


def test_trainer_logs_each_round_with_its_counters(capsys):
    """Every ``densify`` line of the trainer carries the round's counters,
    and the alive count it gives is the one the next step's line reads."""
    trainer.main(["--synthetic", "--steps", "7", "--width", "32", "--height", "24",
                  "--n-init", "120", "--capacity", "600", "--sh-degree", "0", "--cameras", "3",
                  "--densify-every", "2", "--densify-until", "6", "--log-every", "1",
                  "--device", "cpu", "--out", os.devnull])
    lines = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("{")]
    rounds = [i for i, ln in enumerate(lines) if "densify" in ln]
    assert len(rounds) == 3
    for i in rounds:
        ln = lines[i]
        assert set(trace.ROUND_COUNTS) <= set(ln) and ln["granted"] == ln["cloned"] + ln["split"]
        nxt = next(x for x in lines[i + 1:] if "loss" in x)
        assert nxt["alive"] == ln["alive"]
    assert lines[rounds[0]]["granted"] > 0
