"""The port's trainer on captures written to disk (the counterpart of
tests/test_train_e2e.py), on the CPU:

  * one NeRF-synthetic capture through ``apps/train.py --xla`` and
    ``tpusplat_torch.trainer --device cpu``: the step-0 held-out eval and
    the first two losses agree;
  * the NeRF-synthetic dress rehearsal with the reference's own assertions,
    plus ``--ckpt`` (the checkpoint holds the final state) and
    ``--watchdog-secs``;
  * the COLMAP dress rehearsal: the SfM points seed the model.

The captures are written by the reference's own writers."""

import contextlib
import io
import json

import numpy as np
import torch

from tests.test_train_e2e import _write_colmap_dataset, _write_dataset
from tpusplat_torch import trainer
from tpusplat_torch.io.ply import load_ply
from tpusplat_torch.train.checkpoint import load_checkpoint, state_tensors

torch.set_num_threads(2)


def _jax_lines(argv, monkeypatch):
    """Run ``apps/train.py`` with its log values unrounded; its JSON lines."""
    import apps.train as jtrain

    monkeypatch.setattr(jtrain, "round", lambda x, nd=None: x, raising=False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        jtrain.main(argv)
    return [json.loads(ln) for ln in err.getvalue().splitlines() if ln.startswith("{")]


def _port(argv, capsys):
    summary = trainer.main([*argv, "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("{")]
    return summary, lines


def test_step0_eval_and_losses_match_jax(tmp_path, capsys, monkeypatch):
    root = str(tmp_path / "ds")
    _write_dataset(root)
    args = ["--data", root, "--steps", "2", "--log-every", "1", "--eval-every", "1",
            "--holdout", "3", "--n-init", "800", "--sh-degree", "1"]
    want = _jax_lines([*args, "--xla", "--out", str(tmp_path / "j.ply")], monkeypatch)
    summary, _ = _port([*args, "--out", str(tmp_path / "t.ply")], capsys)

    w0 = next(ln for ln in want if ln.get("eval_step") == 0)
    g0 = summary["evals"][0]
    assert g0["eval_step"] == 0 and g0["holdout"] and w0["holdout"]
    assert g0["views"] == w0["views"] == 2
    assert abs(g0["psnr"] - w0["psnr"]) <= 1e-3, (g0["psnr"], w0["psnr"])
    assert abs(g0["ssim"] - w0["ssim"]) <= 1e-4, (g0["ssim"], w0["ssim"])
    w_loss = {ln["step"]: ln["loss"] for ln in want if "loss" in ln}
    got = dict(summary["losses"])
    for step in (1, 2):
        np.testing.assert_allclose(got[step], w_loss[step], rtol=1e-4, err_msg=f"step {step}")


def test_dataset_dress_rehearsal(tmp_path, capsys):
    root = str(tmp_path / "ds")
    _write_dataset(root)
    out_ply, ckpt = str(tmp_path / "trained.ply"), str(tmp_path / "state.npz")
    summary, lines = _port(["--data", root, "--steps", "60", "--n-init", "800",
                            "--sh-degree", "1", "--densify-every", "25", "--log-every", "10",
                            "--eval-every", "20", "--holdout", "3", "--out", out_ply,
                            "--ckpt", ckpt, "--watchdog-secs", "60"], capsys)
    losses = [ln["loss"] for ln in lines if "loss" in ln]
    assert len(losses) >= 3, lines
    assert losses[-1] < losses[0] * 0.9, f"loss did not improve: {losses}"
    assert all(ln.get("overflow", 0) == 0 for ln in lines if "loss" in ln)

    evals = [ln for ln in lines if "psnr" in ln]
    assert len(evals) >= 3 and evals[0]["holdout"] and evals[-1]["final"]
    assert all(e["views"] == 2 for e in evals)
    psnrs = [e["psnr"] for e in evals]
    assert psnrs[-1] > psnrs[0] + 0.5, f"held-out PSNR did not improve: {psnrs}"
    assert psnrs[-1] > 14.0, f"held-out PSNR too low: {psnrs}"
    assert evals[-1]["ssim"] > evals[0]["ssim"], "held-out SSIM regressed"

    # The checkpoint holds the final state, every tensor of it.
    state = summary["state"]
    restored = load_checkpoint(ckpt, state)
    for k, v in state_tensors(state).items():
        assert torch.equal(state_tensors(restored)[k], v), k
    assert int(restored.step) == summary["step"] >= 60

    params = load_ply(out_ply, device="cpu")
    assert params.num_gaussians >= 800  # the alive ones; densification may grow them
    assert bool(params.means.isfinite().all())

    from tpusplat_torch.camera import look_at_camera
    from tpusplat_torch.config import RenderConfig
    from tpusplat_torch.render import render_stages

    cam = look_at_camera([0.0, 0.6, 5.0], [0, 0, 0], 96, 96, fov_deg=60.0, device="cpu")
    img, _ = render_stages(params, cam, RenderConfig(sh_degree=1))
    assert bool(img.isfinite().all())


def test_colmap_dress_rehearsal(tmp_path, capsys):
    root = tmp_path / "capture"
    root.mkdir()
    _write_colmap_dataset(str(root))
    out_ply = str(tmp_path / "colmap_trained.ply")
    _, lines = _port(["--data", str(root), "--steps", "40", "--sh-degree", "1",
                      "--densify-every", "0", "--log-every", "10", "--eval-every", "20",
                      "--out", out_ply], capsys)
    seeded = [ln for ln in lines if "colmap_points" in ln]
    assert seeded and seeded[0]["seeded"] == 600 and seeded[0]["capacity"] == 2400
    losses = [ln["loss"] for ln in lines if "loss" in ln]
    assert len(losses) >= 3
    assert losses[-1] < losses[0] * 0.95, f"loss did not improve: {losses}"
    evals = [ln for ln in lines if "psnr" in ln]
    assert len(evals) >= 2 and evals[-1]["final"] and not evals[-1]["holdout"]
    assert evals[-1]["psnr"] > evals[0]["psnr"], [e["psnr"] for e in evals]
    assert bool(load_ply(out_ply, device="cpu").means.isfinite().all())
