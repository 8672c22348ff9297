"""The port's CLIs on a 1x2 mesh (the counterpart of
tests/test_train_cli_sharded.py): ``python -m tpusplat_torch.trainer --mesh
1x2 [--overlap] --device cpu`` and ``python -m tpusplat_torch.viewer
--mesh 1x2``, each launched as two processes with their rank in the
environment, as torchrun launches them, over gloo and a ``file://``
rendezvous. The loss falls; the eval renders the whole frame with the whole
frame's capacity, though the training capacity was regrown for a strip; the
viewer raises when an overflow outlasts its retries."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]


def _launch(module, args, tmp_path, name, **env):
    """Run ``python -m module args`` as ranks 0 and 1; returns (exit codes,
    rank 0's stderr, rank 1's stderr)."""
    init = tmp_path / f"init_{name}"
    base = {**os.environ, "WORLD_SIZE": "2", "OMP_NUM_THREADS": "2", "PYTHONPATH": str(REPO),
            **env}
    base.pop("MASTER_ADDR", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *args, "--device", "cpu", "--dist-init", f"file://{init}"],
        env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=120)[1])
    finally:
        for p in procs:
            p.kill()
    return [p.returncode for p in procs], *errs


def _lines(err):
    return [json.loads(ln) for ln in err.splitlines() if ln.startswith("{")]


def _train_args(out, steps, *extra):
    return ["--synthetic", "--steps", str(steps), "--n-init", "800", "--width", "64",
            "--height", "64", "--cameras", "2", "--sh-degree", "1", "--densify-every", "0",
            "--opacity-reset-every", "0", "--log-every", "2", "--mesh", "1x2",
            "--out", str(out), *extra]


def test_trainer_mesh_1x2(tmp_path):
    """A training capacity far too small (TPUSPLAT_CAPACITY=1024): the
    first steps overflow and regrow it for a strip; the eval still renders
    the whole frame at its own capacity, 8 x N, without overflow. The
    checkpoint holds the whole state, gathered from both shards."""
    from tpusplat_torch.config import RenderConfig
    from tpusplat_torch.io.ply import load_ply

    out, ckpt = tmp_path / "mesh.ply", tmp_path / "mesh.npz"
    rcs, err0, err1 = _launch("tpusplat_torch.trainer",
                              _train_args(out, 10, "--ckpt", str(ckpt)), tmp_path, "train",
                              TPUSPLAT_CAPACITY="1024")
    assert rcs == [0, 0], err0[-3000:] + err1[-3000:]
    lines = _lines(err0)
    assert not _lines(err1)  # rank 1 logs nothing
    assert any(ln.get("mesh") == "1x2" and ln["backend"] == "gloo" for ln in lines), err0
    assert any("capacity_overflow" in ln for ln in lines), "no regrow: the test shows nothing"
    losses = [ln["loss"] for ln in lines if "loss" in ln]
    assert len(losses) == 5 and all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(ln["overflow"] == 0 for ln in lines if "loss" in ln)
    final = [ln for ln in lines if ln.get("final")]
    n = 4 * 800
    assert final and final[0]["overflow"] == 0 and np.isfinite(final[0]["psnr"])
    assert final[0]["capacity"] == RenderConfig().instance_capacity(n)
    params = load_ply(out, device="cpu")
    assert params.num_gaussians == 800 and bool(params.means.isfinite().all())  # the alive ones
    from tpusplat_torch.train.checkpoint import JAX_LEAVES

    with np.load(ckpt) as data:  # the JAX package's layout: 26 leaves and the treedef
        assert len(data.files) == len(JAX_LEAVES) + 1 == 27
        state = {name: data[f"leaf_{i}"] for i, name in enumerate(JAX_LEAVES)}
    for k, v in state.items():  # every per-Gaussian tensor whole: both shards
        if v.ndim:
            assert v.shape[0] == n, k
    alive = state["params.alive"]
    assert int(state["step"]) == 11 and int(alive.sum()) == 800
    np.testing.assert_array_equal(state["params.means"][alive], params.means.numpy())
    assert np.abs(state["opt_state.means.mu"][alive]).max() > 0


def test_trainer_mesh_1x2_overlap(tmp_path):
    rcs, err0, err1 = _launch("tpusplat_torch.trainer",
                              _train_args(tmp_path / "o.ply", 6, "--overlap"), tmp_path, "ovl")
    assert rcs == [0, 0], err0[-3000:] + err1[-3000:]
    lines = _lines(err0)
    assert any(ln.get("overlap") is True for ln in lines), err0
    losses = [ln["loss"] for ln in lines if "loss" in ln]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_viewer_mesh_1x2_matches_one_process(tmp_path):
    from tpusplat_torch import viewer
    from tpusplat.io.dataset import read_image

    out = tmp_path / "mesh.png"
    rcs, err0, err1 = _launch("tpusplat_torch.viewer",
                              ["test", "-w", "64", "--height", "64", "--sh-degree", "1",
                               "-o", str(out), "--mesh", "1x2"], tmp_path, "view")
    assert rcs == [0, 0], err0[-3000:] + err1[-3000:]
    frame = [ln for ln in _lines(err0) if "frame" in ln]
    assert frame and frame[0]["capacity_overflow"] == 0 and frame[0]["a2a_overflow"] == 0
    one = tmp_path / "one.png"
    viewer.main(["test", "-w", "64", "--height", "64", "--sh-degree", "1", "-o", str(one),
                 "--device", "cpu"])
    got, want = read_image(out), read_image(one)
    assert got.shape == want.shape == (64, 64, 3)
    assert np.abs(got.astype(np.float32) - want.astype(np.float32)).max() <= 1 / 255 + 1e-6


def test_viewer_mesh_raises_on_an_overflow_it_cannot_regrow(tmp_path):
    """TPUSPLAT_MAX_PER_TILE=1 on the plain blend: four renders regrow the
    per-tile cap to 8, still far below the scene's tiles; no frame is saved."""
    out = tmp_path / "never.png"
    rcs, err0, err1 = _launch("tpusplat_torch.viewer",
                              ["test", "-w", "64", "--height", "64", "--sh-degree", "1",
                               "-o", str(out), "--mesh", "1x2"], tmp_path, "ovf",
                              TPUSPLAT_MAX_PER_TILE="1")
    assert rcs[0] != 0 and rcs[1] != 0
    assert "still overflows" in err0 and "RuntimeError" in err0
    assert sum("regrow" in ln for ln in _lines(err0)) == 4
    assert not out.exists()
