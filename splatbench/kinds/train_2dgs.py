"""Traffic of kind ``train_2dgs``: one trainer of 2D Gaussian Splatting
(Huang et al., SIGGRAPH 2024) in a closed loop, as ``tpusplat_torch.trainer``
runs its single-card loop on a surfel scene (``--surfels``) once
densification has ended, with both of the paper's regularizers on:
``compile_train_step`` replayed once a view on a ``SurfelParams`` state
(the scene's type routes the step to the surfel pipeline), views
round-robin on the mix's ``ring``, the overflow counters read one step late
with ``regrow`` on overflow. The loop, the window, the loss layer's span and
the comparison are kind ``train``'s (``kinds/train.py``); the scene, the
weights of the loss and the reference are the surfels'.

Parameters (``traffic/<mix>.json``): those of kind ``train`` (``ring``,
``ssim_weight``, ``capacity_margin``, ``checked_steps``, ``warmup_s``,
``traced_steps``, ``loss_reps``), and ``lambda_dist`` and ``lambda_normal``,
the weights of the mean depth distortion and of the mean normal consistency
in the loss. The program holds them as constants
(``tpusplat_torch.train.losses.LAMBDA_DIST`` and ``LAMBDA_NORMAL``); the
reference takes the mix's, and set-up refuses a mix whose weights differ
from the program's.

The scene: ``inputs.make_scene``'s draws, their first two log-scales the
disks' (``reference_2dgs.surfel_scene``). The capacity is
``capacity_margin`` times the reference's largest instance count over the
views (``reference_2dgs.instances_needed``).

The check (``correct``): the reference (``reference_2dgs.py``, plain
PyTorch, TF32 off, the blend in batches of tiles) takes the same first
``checked_steps`` steps at the full size; compared are each step's loss
(``loss_gap``, relative), the norm of every leaf's first gradient
(``grad_gap``, as the Adam state holds it) and of its change over the steps
(``change_gap``), each leaf's gap over the larger of its norm and the
median leaf's (``drive.leaf_gap``). ``check(dtype, fault)`` also gives the
bfloat16 control and the reference with a planted fault
(``reference_2dgs.FAULTS``), which ``calibrate_2dgs.py`` reads.
"""

from __future__ import annotations

import statistics

import torch

from splatbench import drive, inputs, reference
from splatbench import reference_2dgs as r2

Train = drive.load_kind("train")


class Mix(Train):
    FAULTS = r2.FAULTS

    def setup(self):
        from tpusplat_torch.config import regrow
        from tpusplat_torch.train import losses
        from tpusplat_torch.train.step import (B1, TRAINABLE, compile_train_step,
                                               create_train_state, make_optimizer)
        from tpusplat_torch.types import SurfelParams

        run, conf, mix, dev = self.run, self.run.conf, self.run.traffic, self.run.device
        weights = (float(mix["lambda_dist"]), float(mix["lambda_normal"]))
        if weights != (losses.LAMBDA_DIST, losses.LAMBDA_NORMAL):
            raise ValueError(f"train_2dgs: the mix's lambda_dist, lambda_normal {weights} are "
                             f"not the program's ({losses.LAMBDA_DIST}, "
                             f"{losses.LAMBDA_NORMAL})")
        self.regrow = regrow
        scene = r2.surfel_scene(conf, run.seed, dev)
        self.targets = inputs.make_targets(conf, run.seed, dev)
        self.mats = inputs.training_views(conf, mix["ring"], run.seed)
        self.cams = [drive.program_camera(m, dev) for m in self.mats]
        needed = r2.instances_needed(scene, self.mats, conf)
        self.cfg = drive.render_config(conf, needed * mix["capacity_margin"])
        self.opt = make_optimizer(scene_extent=float(conf["extent"]))
        self.step = compile_train_step()
        self.state = create_train_state(SurfelParams(**scene))
        run.notes.update(instances_needed=needed, capacity=self.cfg.capacity)

        losses, gated = [], 0
        for i in range(mix["checked_steps"]):
            self.state, metrics = self.step(self.state, self.cams[i], self.targets[i], self.cfg,
                                            self.opt, mix["ssim_weight"])
            losses.append(float(metrics["loss"]))
            gated += int(metrics["capacity_overflow"] + metrics["gauss_overflow"]
                         + metrics["tile_overflow"]) > 0
            if i == 0:
                grad_norms = {k: reference.norm(self.state.mu[k] / (1 - B1)) for k in TRAINABLE}
        change = {k: reference.norm(getattr(self.state.params, k) - scene[k]) for k in TRAINABLE}
        self.prog = dict(losses=losses, grad_norms=grad_norms, change_norms=change)
        run.notes.update(checked_steps_gated=gated)
        del scene
        self.seq = mix["checked_steps"]
        self.regrown: list = []
        warm = self.loop(float(mix["warmup_s"]))
        run.notes.update(warmup_steps=warm["applied"], regrows_warmup=warm["regrows"])

    def check(self, dtype=torch.float32, fault=None):
        """The reference's first steps: each step's loss, the first
        gradient's norms and the steps' change of each leaf; with ``fault``,
        the reference with that fault planted."""
        run, conf, mix, dev = self.run, self.run.conf, self.run.traffic, self.run.device
        with reference.full_fp32():
            p0 = reference.cast(r2.surfel_scene(conf, run.seed, dev), dtype)
            p, st = dict(p0), reference.adam_state(p0)
            losses, pairs, grad_norms = [], [], None
            for i in range(mix["checked_steps"]):
                cam = reference.camera(self.mats[i], dtype, dev)
                value, grads, pr = r2.train_step(p, cam, self.targets[i].to(dtype), conf, mix,
                                                 fault)
                if i == 0:
                    grad_norms = {k: reference.norm(grads[k]) for k in reference.FIELDS}
                losses.append(value)
                pairs.append(pr)
                p = reference.adam(p, grads, st, float(conf["extent"]))
            change = {k: reference.norm(p[k].float() - p0[k].float()) for k in reference.FIELDS}
        if fault is None and dtype == torch.float32:
            run.work.update(alive=conf["gaussians"], slots=conf["gaussians"],
                            **{k: statistics.mean(pr[k] for pr in pairs) for k in pairs[0]})
        return dict(losses=losses, grad_norms=grad_norms, change_norms=change)
