"""Traffic of kind ``train``: one trainer, closed loop, as
``tpusplat_torch.trainer`` runs its single-card loop without ``--mesh``
once densification has ended (3DGS densifies up to iteration 15,000 of
30,000; the second half trains a fixed set of Gaussians):
``compile_train_step`` replayed once a view, views round-robin on the
mix's ``ring`` of cameras, the overflow counters read one step late with
``regrow`` on overflow.

Parameters (``traffic/<mix>.json``): ``ring`` (``radius``,
``height_jitter``), ``ssim_weight``, ``capacity_margin`` (over the
reference's count of the instances the views need), ``checked_steps``,
``warmup_s`` (the loop run untimed at the end of set-up), ``traced_steps``
(the traced part of a ``--trace 1`` window), ``loss_reps``.
"""

from __future__ import annotations

import collections
import gc
import statistics
import time

import torch

from splatbench import drive, inputs, reference


class Mix:
    def __init__(self, run: drive.Run):
        self.run = run

    def setup(self):
        from tpusplat_torch.config import regrow
        from tpusplat_torch.train.step import (B1, TRAINABLE, compile_train_step,
                                               create_train_state, make_optimizer)

        run, conf, mix, dev = self.run, self.run.conf, self.run.traffic, self.run.device
        self.regrow = regrow
        scene = inputs.make_scene(conf, run.seed, dev)
        self.targets = inputs.make_targets(conf, run.seed, dev)
        self.mats = inputs.training_views(conf, mix["ring"], run.seed)
        self.cams = [drive.program_camera(m, dev) for m in self.mats]
        needed = reference.instances_needed(scene, self.mats, conf)
        self.cfg = drive.render_config(conf, needed * mix["capacity_margin"])
        self.opt = make_optimizer(scene_extent=float(conf["extent"]))
        self.step = compile_train_step()
        self.state = create_train_state(drive.program_params(scene))
        run.notes.update(instances_needed=needed, capacity=self.cfg.capacity)

        # The checked steps: the first steps of the object the window drives,
        # through its own call, on distinct views.
        losses, gated = [], 0
        for i in range(mix["checked_steps"]):
            self.state, metrics = self.step(self.state, self.cams[i], self.targets[i], self.cfg,
                                            self.opt, mix["ssim_weight"])
            losses.append(float(metrics["loss"]))
            gated += int(metrics["capacity_overflow"] + metrics["gauss_overflow"]
                         + metrics["tile_overflow"]) > 0
            if i == 0:  # the first gradient, as the optimizer got it
                grad_norms = {k: reference.norm(self.state.mu[k] / (1 - B1)) for k in TRAINABLE}
        change = {k: reference.norm(getattr(self.state.params, k) - scene[k]) for k in TRAINABLE}
        self.prog = dict(losses=losses, grad_norms=grad_norms, change_norms=change)
        run.notes.update(checked_steps_gated=gated)
        del scene
        self.seq = mix["checked_steps"]
        self.regrown: list = []
        # The same loop, untimed: clocks and caches settle before the window.
        warm = self.loop(float(mix["warmup_s"]))
        run.notes.update(warmup_steps=warm["applied"], regrows_warmup=warm["regrows"])

    def loop(self, seconds: float, traced_steps: int = 0) -> dict:
        """Steps in a closed loop for ``seconds`` (at least one), round-robin
        over the views. With ``traced_steps``, a traced window is open over
        the first that many steps."""
        mix, views = self.run.traffic, len(self.cams)
        inflight, retry = collections.deque(), collections.deque()
        out = dict(applied=0, attempted=0, regrows=0, traced=None)

        def poll():
            i, metrics = inflight.popleft()
            with drive.span("read_counters"):
                cfg, changes = self.regrow(self.cfg, metrics, self.state.params.num_gaussians)
            if changes is not None:
                self.cfg = cfg
                retry.append(i)
                out["regrows"] += 1
                self.regrown.append(sorted(k for k in changes if not k.endswith("_regrow")))
                return
            out["applied"] += 1

        tracing = drive.open_window() if traced_steps else None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or out["attempted"] == 0:
            if retry:
                i = retry.popleft()
            else:
                i = self.seq % views
                self.seq += 1
            with drive.span("train_step"):
                self.state, metrics = self.step(self.state, self.cams[i], self.targets[i],
                                                self.cfg, self.opt, mix["ssim_weight"])
            out["attempted"] += 1
            inflight.append((i, metrics))
            if len(inflight) >= 2:
                poll()
            if tracing is not None and out["attempted"] >= traced_steps:
                drive.close_window(tracing)  # synchronises: the steps in flight ran
                out["traced"] = (tracing, out["attempted"], time.perf_counter(),
                                 out["attempted"])
                tracing = None
        while inflight:
            poll()
        drive.sync(self.run.device)
        t1 = time.perf_counter()
        out["seconds"] = t1 - t0
        if tracing is not None:
            drive.close_window(tracing)
            out["traced"] = (tracing, out["attempted"], t1, out["attempted"])
        if out["traced"] is not None:
            tracing, units, rest_t0, at = out["traced"]
            out["traced"] = (tracing, units, t1 - rest_t0, out["attempted"] - at)
        return out

    def window(self):
        run = self.run
        res = self.loop(run.seconds, run.traffic["traced_steps"] if run.traced else 0)
        run.attempted, run.units, run.window_s = res["attempted"], res["applied"], res["seconds"]
        run.failed = res["regrows"]
        run.e2e["train_mpix_s"] = run.units * run.pixels / run.window_s / 1e6
        if res["traced"] is not None:
            run.read_trace(*res["traced"])
        run.notes.update(steps=run.units, regrows_in_window=res["regrows"],
                         regrown=self.regrown, captures=self.step.stats["captures"])

    def free(self):
        self.state = self.step = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def loss_span(self):
        """The loss layer alone: ``gs_loss`` forward and backward at the
        cell's frame, on a seeded image and the first target."""
        from tpusplat_torch.train.losses import gs_loss

        run, dev = self.run, self.run.device
        g = torch.Generator(device=dev)
        g.manual_seed(run.seed)
        img = torch.rand(self.targets[0].shape, generator=g, device=dev).requires_grad_(True)
        timer = drive.Timer(dev)
        for i in range(3 + run.traffic["loss_reps"]):
            if i >= 3:
                timer.start()
            torch.autograd.grad(gs_loss(img, self.targets[0], run.traffic["ssim_weight"]), img)
            if i >= 3:
                timer.stop()
        run.spans["loss"] = timer.ms()

    def check(self, dtype=torch.float32, fault=None):
        """The reference's first steps against the program's: each step's
        loss, the first gradient's norm and the three steps' change of each
        parameter leaf."""
        run, conf, mix, dev = self.run, self.run.conf, self.run.traffic, self.run.device
        with reference.full_fp32():
            p0 = reference.cast(inputs.make_scene(conf, run.seed, dev), dtype)
            p, st = dict(p0), reference.adam_state(p0)
            losses, pairs, grad_norms = [], [], None
            for i in range(mix["checked_steps"]):
                cam = reference.camera(self.mats[i], dtype, dev)
                value, grads, pr = reference.train_step(p, cam, self.targets[i].to(dtype), conf,
                                                        mix["ssim_weight"], fault)
                if i == 0:
                    grad_norms = {k: reference.norm(grads[k]) for k in reference.FIELDS}
                losses.append(value)
                pairs.append(pr)
                p = reference.adam(p, grads, st, float(conf["extent"]))
            change = {k: reference.norm(p[k].float() - p0[k].float()) for k in reference.FIELDS}
        ref = dict(losses=losses, grad_norms=grad_norms, change_norms=change)
        if fault is None and dtype == torch.float32:
            run.work.update(alive=conf["gaussians"], slots=conf["gaussians"],
                            **{k: statistics.mean(pr[k] for pr in pairs) for k in pairs[0]})
        return ref

    def readings(self, ref: dict) -> dict:
        return self.compare(self.prog, ref)

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        """The numbers compared: the worst step's relative loss gap and the
        worst leaf's gaps of the first gradient's and the change's norms."""
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
        return dict(loss_gap=loss_gap,
                    grad_gap=drive.leaf_gap(prog["grad_norms"], ref["grad_norms"])[0],
                    change_gap=drive.leaf_gap(prog["change_norms"], ref["change_norms"])[0])
