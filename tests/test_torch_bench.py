"""The port's bench tools (``tpusplat_torch.bench``) rehearsed on the CPU at
tiny sizes: each module's functions run end to end through the plain
versions of the kernels (the numbers they time here are host-clock times of
the CPU and say so: ``clock == "host"``); the GPU gate's checks pass,
its golden check included; its gradient normalisation equals the JAX
gate's; the strip projection's and the comm accounting's arithmetic against
numbers worked by hand; and every ``main()`` refuses to run without a card
(the gate with exit code 2 and a ``skipped`` line)."""

import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusplat_torch.bench import (
    _timing, gpu_gate, kernel_bench, micro, plumb_bench, profile_detail, scaling, strip_bench,
    strip_projection,
)

torch.set_num_threads(2)

TINY = dict(n=3000, w=96, h=64, sh=1, cap=8, srange=(0.02, 0.1))
SQUARE = dict(n=8000, w=128, h=128, sh=1, cap=8, srange=(0.02, 0.1))


def test_profile_detail_rehearsal():
    """The stage table comes from the stamps of a compiled frame's and a
    compiled train step's replays, under the stage names of PERF.md and the
    cells; on the CPU the stamps take the host clock and say so."""
    res = profile_detail.run(TINY, "cpu", reps=2, window_steps=1)
    assert list(res["frame"]) == ["preprocess", "binning", "blend", "gap", "unit"]
    assert list(res["train"]) == ["preprocess", "binning", "blend", "loss", "blend_bwd",
                                  "preprocess_bwd", "adam", "writeback", "gap", "unit"]
    for table in (res["frame"], res["train"]):
        assert all(v >= 0 for v in table.values()) and table["unit"] > 0
        stages = sum(v for k, v in table.items() if k not in ("gap", "unit"))
        assert stages == pytest.approx(table["unit"], rel=0.2)
    assert res["mpix_per_s"] > 0
    assert res["clock"] == "host" and 0 < res["num_instances"] <= res["capacity"]
    win = res["train_window"]
    # No device on the CPU: the window says so rather than report a share.
    assert win["idle_share"] is None and win["profiler_device_events"] == 0
    assert win["overflow"] == 0 and win["window_ms"] > 0
    strip = profile_detail.run_strip(2, "cpu", conf=SQUARE, reps=1)
    assert strip["strip_instances"] > 0 and strip["row0"] == strip["nrows"]


@pytest.mark.parametrize("intervals,lo,hi,want_us", [
    ([(0, 10), (5, 20), (30, 40)], 0, 100, 30),
    ([(0, 10), (10, 20)], 0, 100, 20),
    ([(0, 10), (2, 3), (50, 60)], 5, 55, 10),
    ([(60, 70)], 0, 50, 0),
    ([], 0, 10, 0),
])
def test_profiler_busy_union(intervals, lo, hi, want_us):
    """The device-busy time is the union of the intervals inside the window."""
    assert _timing._merged_ms(intervals, lo, hi) == pytest.approx(want_us / 1e3)


GATE_SIZES = dict(strip=dict(n=3000, w=128, h=128), compact=dict(n=8000, w=64, h=512),
                  plain=dict(n=2000, w=96, h=64), golden=dict(n=300, w=64, h=48))


@pytest.mark.parametrize("check", ["strip", "compact", "plain", "golden"])
def test_gate_check_rehearsal(check):
    fn = dict(strip=gpu_gate.check_strip_path, compact=gpu_gate.check_compact_exchange,
              plain=gpu_gate.check_cuda_vs_plain, golden=gpu_gate.check_cuda_vs_golden)[check]
    out = fn(device="cpu", **GATE_SIZES[check])
    oks = out[1::2] if check == "plain" else out[1:]
    assert all(oks), out
    if check == "golden":  # the pipeline against the independent oracle
        assert out[0]["num_instances"] > 0
    if check == "compact":
        assert out[0]["gauss_capacity"] is not None


def test_gate_run_rehearsal():
    out = gpu_gate.run("cpu", GATE_SIZES, log=io.StringIO())
    assert out["pass"] and set(out["tolerances"]) == {
        "img_atol", "grad_atol", "golden_img_atol", "golden_grad_atol", "prod_img_atol",
        "prod_grad_atol"}


def test_grad_diffs_matches_jax():
    from tpusplat.bench.tpu_gate import _grad_diffs as jax_grad_diffs

    rng = np.random.default_rng(0)
    shapes = dict(means=(50, 3), log_scales=(50, 3), quats=(50, 4), opacities=(50,),
                  sh=(50, 16, 3))
    ref = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    test = {k: (v + rng.normal(scale=1e-3, size=v.shape)).astype(np.float32)
            for k, v in ref.items()}
    ref["opacities"][:] = 0.0  # the 1e-12 guard
    want = jax_grad_diffs(ref, test)
    got = gpu_gate.grad_diffs({k: torch.from_numpy(v) for k, v in ref.items()},
                              {k: torch.from_numpy(v) for k, v in test.items()})
    assert got == want


def test_render_plain_equals_render_stages():
    """The gate's plain composition is the CPU route of ``render_stages``."""
    from tpusplat_torch.render import render_stages

    params, cam, cfg = profile_detail.scene(TINY, "cpu")
    img, aux = gpu_gate.render_plain(params, cam, cfg)
    ref, ref_aux = render_stages(params, cam, cfg)
    assert torch.equal(img, ref)
    assert int(aux["num_instances"]) == int(ref_aux["num_instances"])


def test_kernel_bench_rehearsal(tmp_path):
    first = kernel_bench.run(TINY, "cpu", reps=1, cache_dir=tmp_path)
    again = kernel_bench.run(TINY, "cpu", reps=1, cache_dir=tmp_path)
    assert not first["cache_hit"] and again["cache_hit"] and first["cache"] == again["cache"]
    assert Path(first["cache"]).parent == tmp_path
    assert first["clock"] == "host" and first["fwd_ms"] > 0 and first["bwd_ms"] > 0


def test_plumb_bench_rehearsal():
    res = plumb_bench.run(device="cpu", conf=TINY, c=5000, n=1000, reps=1)
    assert res["expand_match"] and res["instances"] > 0
    assert res["segreduce_max_abs_err"] <= 1e-4
    assert {"expand_cuda", "expand_plain", "grad_sort_9payload", "segreduce_cuda",
            "segreduce_plain"} <= set(res)


def test_micro_rehearsal():
    """Every primitive of the JAX micro bench, by its name."""
    src = (Path(__file__).resolve().parents[1] / "tpusplat" / "bench" / "micro.py").read_text()
    jax_names = set(re.findall(r'r\["(\w+)"\]', src))
    res = micro.run("cpu", c=5000, n=1000, t=64, reps=1)
    assert set(res["ms"]) == jax_names and res["clock"] == "host"


def test_strip_bench_rehearsal():
    res = strip_bench.run(2, "cpu", conf=SQUARE, reps=1)
    assert len(res["strip_fwd_bwd_ms"]) == 2 and sum(res["strip_instances"]) > 0
    assert set(res["projection"]) == {"pipe_ms_per_card", "nvlink_50pct", "nvlink_100pct"}
    assert res["link"]["gbps_per_direction"] == 450.0
    params, cam, cfg = profile_detail.scene(SQUARE, "cpu")
    proj = strip_projection.measure_strip_projection(params, cam, cfg, 2, 1, t_full_ms=10.0)
    assert proj["link_gbps"] == 225.0 and proj["frame_ms"] > 0


def test_strip_projection_arithmetic():
    """Worked by hand: the slowest strip 20 ms, the whole frame's
    preprocess 5 ms and the shard's 1 ms give a 16 ms pipeline; 45 MB at
    225 GB/s (half of 450) is 0.2 ms, at 450 GB/s 0.1 ms; 1080p is 2.0736
    Mpix; one card's 100 ms frame over 8 cards of 16.2 ms is 0.7716."""
    p = strip_bench.project(20.0, 5.0, 1.0, 30_000_000, 15_000_000, 8, 2.0736, 100.0)
    assert p["pipe_ms_per_card"] == pytest.approx(16.0)
    half, full = p["nvlink_50pct"], p["nvlink_100pct"]
    assert half["gbps"] == 225.0 and full["gbps"] == 450.0
    assert half["comm_ms"] == pytest.approx(0.2) and full["comm_ms"] == pytest.approx(0.1)
    assert half["frame_ms"] == pytest.approx(16.2) and full["frame_ms"] == pytest.approx(16.1)
    assert half["mpix_per_s"] == pytest.approx(2.0736 / 16.2 * 1e3)
    assert half["scaling_eff_vs_1card"] == pytest.approx(100.0 / (8 * 16.2))
    assert strip_bench.project(1.0, 0.0, 0.0, 0, 0, 2, 1.0, None)["nvlink_50pct"][
        "scaling_eff_vs_1card"] is None
    # Garden over 8 shards: 1.4M x 16 columns x 4 bytes x 7/8 gathered,
    # 9 gradient rows scattered back.
    from tpusplat.parallel.collectives import tile_exchange_bytes as jax_bytes
    from tpusplat_torch.parallel.collectives import tile_exchange_bytes

    assert tile_exchange_bytes(1_400_000, 8) == dict(allgather=78_400_000,
                                                     psum_scatter=44_100_000)
    assert tile_exchange_bytes(1_400_000, 8) == jax_bytes(1_400_000, 8)
    # A strip's capacity: 35% over an even split, up to a multiple of 1024.
    assert strip_bench.strip_capacity(8_000_000, 8) == 1_350_656


def test_scaling_comm_accounting():
    """1.4M Gaussians x 59 floats x 4 bytes = 330.4 MB; a two-host ring
    sends 2 (2-1)/2 of it in 2 chunks: 13.216 ms at the assumed 25 GB/s,
    one chunk (6.608 ms) exposed when overlapped."""
    acct = scaling.comm_accounting()
    assert acct["grad_mb"] == pytest.approx(330.4)
    assert acct["ring_mb_per_host"] == pytest.approx(330.4)
    assert acct["chunks"] == 2 and acct["assumed_gbps_per_host"] == 25.0
    assert acct["comm_ms_at_assumed_rate"] == pytest.approx(13.216)
    assert acct["exposed_ms_if_overlapped"] == pytest.approx(6.608)


def test_scaling_rehearsal():
    res = scaling.run(2, "cpu", "gloo", iters=1)
    assert res["mesh"] == "2x1" and res["clock"] == "host"
    assert set(res["step_ms"]) == {"monolithic_psum", "overlap_psum", "overlap_ring"}
    assert all(v > 0 for v in res["step_ms"].values())


def test_timing_on_the_cpu():
    ms, out = _timing.time_ms(lambda: 7, "cpu", reps=2)
    assert out == 7 and ms >= 0
    assert _timing.clock("cpu") == "host" and _timing.device_info("cpu") == {"kind": "cpu"}
    calls = []
    win = _timing.profiled(lambda: calls.append(len(calls)) or len(calls), "cpu", calls=3)
    assert win.out == 3 and calls == [0, 1, 2]
    assert win.window_ms > 0 and win.busy_ms == 0 and win.ops == {} and win.counts() == {}


MAINS = {"profile_detail": profile_detail.main, "kernel_bench": kernel_bench.main,
         "plumb_bench": plumb_bench.main, "micro": micro.main, "strip_bench": strip_bench.main,
         "scaling": scaling.main}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_refuses_without_a_card(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the bench would run")
    assert MAINS[name]([]) != 0
    err = capsys.readouterr().err
    assert "no CUDA device" in err


def test_gate_main_skips_with_code_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the gate would run")
    assert gpu_gate.main([]) == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["skipped"] is True
