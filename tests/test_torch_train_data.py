"""The port's trainer on captures written to disk (the counterpart of
tests/test_train_e2e.py), on the CPU:

  * one NeRF-synthetic capture through ``apps/train.py --xla`` and
    ``tpusplat_torch.trainer --device cpu``: the step-0 held-out eval and
    the first two losses agree;
  * a whole synthetic run through both, three densify rounds (clones and
    splits, their noise drawn from the same threefry keys) and an opacity
    reset: every log line, the two output PLYs and the two ``--ckpt``
    files agree, and each package reads the other's file;
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
from tpusplat_torch.train import densify
from tpusplat_torch.train.checkpoint import JAX_LEAVES, load_checkpoint, state_tensors
from tpusplat_torch.train.step import make_optimizer

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


def test_whole_run_through_densify_matches_jax(tmp_path, capsys, monkeypatch):
    """14 synthetic steps with a densify round every 4 steps up to step 12
    and an opacity reset at step 8. Round 1 splits (no initial Gaussian is
    small enough to clone: its scales start in [0.05, 0.25], the clone limit
    is 0.01 * the extent 6), round 2 clones and splits, round 3, after the
    reset, finds no candidate but still takes its key. Every log line: alive
    equal, loss at rtol 1e-4; the PLYs: the same Gaussians, parameters at 2
    lr steps a step; the checkpoints, leaf by leaf (see _compare_checkpoints)."""
    steps = 14
    args = ["--synthetic", "--steps", str(steps), "--width", "64", "--height", "48",
            "--n-init", "200", "--capacity", "2400", "--sh-degree", "1", "--cameras", "4",
            "--densify-every", "4", "--densify-until", "12", "--opacity-reset-every", "8",
            "--log-every", "1"]
    jckpt, tckpt = tmp_path / "j.npz", tmp_path / "t.npz"
    want = _jax_lines([*args, "--xla", "--out", str(tmp_path / "j.ply"), "--ckpt", str(jckpt)],
                      monkeypatch)

    rounds = []
    port_densify = densify.densify_and_prune

    def counted(state, *a, **kw):
        out = port_densify(state, *a, **kw)
        before = state.params.alive
        split = int((before & (out.params.log_scales != state.params.log_scales).any(-1)).sum())
        new = int((out.params.alive & ~before).sum())
        rounds.append(dict(split=split, clone=new - split))
        return out

    monkeypatch.setattr(densify, "densify_and_prune", counted)
    summary, lines = _port([*args, "--out", str(tmp_path / "t.ply"), "--ckpt", str(tckpt)],
                           capsys)
    assert len(rounds) == 3 and all(r["split"] for r in rounds[:2]) and rounds[1]["clone"], rounds

    w_lines = [ln for ln in want if "loss" in ln]
    got = [ln for ln in lines if "loss" in ln]
    assert [ln["step"] for ln in got] == [ln["step"] for ln in w_lines]
    alive = ([ln["alive"] for ln in got], [ln["alive"] for ln in w_lines])
    np.testing.assert_allclose([v for _, v in summary["losses"]],
                               [ln["loss"] for ln in w_lines], rtol=1e-4,
                               err_msg=f"alive (port, JAX): {alive}")
    assert alive[0] == alive[1]
    assert alive[1][-1] > 3 * alive[1][0]

    pj = load_ply(tmp_path / "j.ply", device="cpu", use_native=False)
    pt = load_ply(tmp_path / "t.ply", device="cpu", use_native=False)
    assert pt.num_gaussians == pj.num_gaussians == w_lines[-1]["alive"]
    opt = make_optimizer(scene_extent=6.0)
    lrs = dict(means=opt.means_lr * opt.scene_extent, log_scales=opt.scales_lr,
               quats=opt.quats_lr, opacities=opt.opacities_lr, sh=opt.sh_lr)
    for f, lr in lrs.items():
        np.testing.assert_allclose(getattr(pt, f).numpy(), getattr(pj, f).numpy(),
                                   atol=2 * lr * steps, err_msg=f)
    _compare_checkpoints(jckpt, tckpt, lrs, steps, summary["state"])


def _compare_checkpoints(jax_path, port_path, lrs, steps, port_state):
    """The two trainers' checkpoints of the same run, leaf by leaf: alive,
    step, the counts and grad_count equal; the parameters at the PLYs'
    bounds; Adam's moments within 1e-3 of each leaf's largest magnitude;
    grad_accum at rtol 1e-3, max_radii at atol 1 (the largest differences
    are printed). Then each package loads the other's file."""
    import jax

    from tpusplat.io.synthetic import random_scene as jax_random_scene
    from tpusplat.train import checkpoint as jax_checkpoint
    from tpusplat.train.step import create_train_state, make_optimizer as jax_optimizer

    largest = {}
    with np.load(jax_path) as jf, np.load(port_path) as tf:
        assert sorted(jf.files) == sorted(tf.files)
        assert jf["__treedef__"].tobytes() == tf["__treedef__"].tobytes()
        for i, name in enumerate(JAX_LEAVES):
            j, t = jf[f"leaf_{i}"], tf[f"leaf_{i}"]
            assert j.dtype == t.dtype and j.shape == t.shape, name
            if name.endswith(("count", ".alive")) or name == "step":
                np.testing.assert_array_equal(t, j, err_msg=name)
                continue
            err = float(np.abs(t - j).max())
            if name.startswith("params."):
                largest[name] = err
                np.testing.assert_allclose(t, j, atol=2 * lrs[name[7:]] * steps, err_msg=name)
            elif name.endswith((".mu", ".nu")):
                largest[name] = err / float(np.abs(j).max())
                np.testing.assert_allclose(t, j, atol=1e-3 * np.abs(j).max(), err_msg=name)
            elif name == "grad_accum":
                largest[name] = float((np.abs(t - j) / np.maximum(np.abs(j), 1e-30)).max())
                np.testing.assert_allclose(t, j, rtol=1e-3, err_msg=name)
            else:
                largest[name] = err
                np.testing.assert_allclose(t, j, atol=1, err_msg=name)
        n = jf["leaf_0"].shape[0]
    print("checkpoint differences (params: abs; moments: over the leaf's largest; "
          "grad_accum: relative; max_radii: abs):", json.dumps(largest))

    ported = load_checkpoint(port_path, port_state)
    from_jax = load_checkpoint(jax_path, port_state)
    assert torch.equal(from_jax.params.alive, ported.params.alive)
    assert torch.equal(from_jax.step, ported.step)
    back = jax_checkpoint.load_checkpoint(
        str(port_path), create_train_state(jax_random_scene(n), jax_optimizer()))
    for name, leaf in zip(JAX_LEAVES, jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(leaf), state_tensors(ported)[name].numpy()), name


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
