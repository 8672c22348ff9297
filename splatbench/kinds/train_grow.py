"""Traffic of kind ``train_grow``: one trainer, closed loop, in 3DGS's
densification phase (iterations 500 to 15,000 of 30,000), as
``tpusplat_torch.trainer`` runs its single-card loop without ``--mesh``:
``compile_train_step`` replayed once a view, views round-robin on the mix's
``ring``, the overflow counters read one step late with ``regrow`` on
overflow, and every ``densify_every`` applied steps a densify round
through ``compile_densify``, its key a tensor split from
``prng.key(seed)`` once a round, with ``DensifyConfig()``'s defaults. The
scene holds ``gaussians`` slots of which the first ``alive_at_start`` are
alive; its scales are drawn log-uniform over ``scale_range``
(:func:`grow_scene`).

Set-up runs a fixed number of steps, not seconds, so that every run of a
seed starts its window from the same state: the ``checked_steps``, then the
loop to applied step ``checked_round_at``, where the round is checked (its
input state copied aside first), then on to ``window_from_step``. The loop
ends on a step, never on a round. The round counters
(``tpusplat_torch.trace.rounds``) are read once the window has closed; a
port without them leaves them out.

Parameters (``traffic/<mix>.json``): those of kind ``train`` but
``warmup_s``, and ``densify_every``, ``checked_round_at`` and
``window_from_step``.
"""

from __future__ import annotations

import collections
import gc
import math
import statistics
import time

import torch

from splatbench import drive, inputs, reference
from splatbench import reference_densify as rd

Train = drive.load_kind("train")
SCALE_SEED = 2  # the log-scales' generator: the seed plus this (the targets take plus 1)
NOISE_SEED = 3  # the reference round's own split draws, never compared


def grow_scene(conf: dict, seed: int, device) -> dict:
    """``inputs.make_scene``'s scene with log-scales uniform in the log of
    ``scale_range`` and ``alive`` true on the first ``alive_at_start``
    slots; the others keep their drawn values, dead."""
    scene = inputs.make_scene(conf, seed, device)
    n = conf["gaussians"]
    lo, hi = (math.log(s) for s in conf["scale_range"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + SCALE_SEED)
    scene["log_scales"] = lo + torch.rand((n, 3), generator=g, device=device) * (hi - lo)
    scene["alive"] = torch.arange(n, device=device) < conf["alive_at_start"]
    return scene


def state_dict(state) -> dict:
    """The program's train state as the plain round's dict, copied."""
    p = state.params
    out = {f: getattr(p, f).clone() for f in rd.PARAMS + ("alive",)}
    out.update(mu={k: v.clone() for k, v in state.mu.items()},
               nu={k: v.clone() for k, v in state.nu.items()},
               **{f: getattr(state, f).clone() for f in rd.STATS})
    return out


def allocator(dev) -> dict:
    if dev.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(dev)
    return dict(reserved_gib=s.get("reserved_bytes.all.current", 0) / 2 ** 30,
                retries=s.get("num_alloc_retries", 0), ooms=s.get("num_ooms", 0))


class Mix(Train):
    FAULTS = ("unchanged", "no_stats") + rd.FAULTS  # planted by the calibration

    def setup(self):
        from tpusplat_torch.config import regrow
        from tpusplat_torch.train import prng
        from tpusplat_torch.train.densify import DensifyConfig, compile_densify
        from tpusplat_torch.train.step import (B1, TRAINABLE, compile_train_step,
                                               create_train_state, make_optimizer)

        run, conf, mix, dev = self.run, self.run.conf, self.run.traffic, self.run.device
        self.regrow, self.prng = regrow, prng
        scene = grow_scene(conf, run.seed, dev)
        self.targets = inputs.make_targets(conf, run.seed, dev)
        self.mats = inputs.training_views(conf, mix["ring"], run.seed)
        self.cams = [drive.program_camera(m, dev) for m in self.mats]
        needed = reference.instances_needed(scene, self.mats, conf)
        self.cfg = drive.render_config(conf, needed * mix["capacity_margin"])
        self.opt = make_optimizer(scene_extent=float(conf["extent"]))
        self.step = compile_train_step()
        self.round = compile_densify()
        self.dcfg = DensifyConfig()
        self.key = prng.key(run.seed)
        self.state = create_train_state(drive.program_params(scene))
        run.notes.update(instances_needed=needed, capacity=self.cfg.capacity)
        del scene

        # The checked steps: the first steps of the object the window drives.
        losses, gated = [], 0
        for i in range(mix["checked_steps"]):
            self.state, metrics = self.step(self.state, self.cams[i], self.targets[i], self.cfg,
                                            self.opt, mix["ssim_weight"])
            losses.append(float(metrics["loss"]))
            gated += int(metrics["capacity_overflow"] + metrics["gauss_overflow"]
                         + metrics["tile_overflow"]) > 0
            if i == 0:
                grad_norms = {k: reference.norm(self.state.mu[k] / (1 - B1)) for k in TRAINABLE}
        scene = grow_scene(conf, run.seed, dev)
        change = {k: reference.norm(getattr(self.state.params, k) - scene[k]) for k in TRAINABLE}
        del scene
        stats = {f: reference.norm(getattr(self.state, f)) for f in rd.STATS}
        self.prog = dict(losses=losses, grad_norms=grad_norms, change_norms=change,
                         stats_norms=stats)
        run.notes.update(checked_steps_gated=gated)
        self.seq = self.applied = mix["checked_steps"]
        self.next_round = mix["densify_every"]
        self.rounds_at: list = []  # the applied step of each round
        self.regrown: list = []
        alloc0 = allocator(dev)

        # On to the checked round, the round, and on to the window.
        self.loop(until=mix["checked_round_at"])
        self.prog["pre"] = state_dict(self.state)
        self.densify()
        self.prog["post"] = state_dict(self.state)
        self.loop(until=mix["window_from_step"])
        run.notes.update(setup_steps=self.applied, regrows_setup=len(self.regrown),
                         allocator_setup=[alloc0, allocator(dev)])

    def densify(self):
        """One round through the compiled object, its key split from the
        chain as the trainer splits it."""
        self.key, sub = self.prng.split(self.key)
        with drive.span("densify"):
            self.state = self.round(self.state, self.prng.key_tensor(sub, self.run.device),
                                    self.dcfg, float(self.run.conf["extent"]))
        self.rounds_at.append(self.applied)
        self.next_round += self.run.traffic["densify_every"]

    def loop(self, seconds: float | None = None, until: int | None = None,
             traced_steps: int = 0) -> dict:
        """Steps in a closed loop, round-robin over the views, for
        ``seconds`` (at least one step) or until ``until`` steps have been
        applied in all; a round is due once ``densify_every`` more steps
        have been applied, and runs before the next step. With
        ``traced_steps``, a traced window is open over the first that many
        steps."""
        mix, views = self.run.traffic, len(self.cams)
        inflight, retry = collections.deque(), collections.deque()
        out = dict(applied=0, attempted=0, regrows=0, rounds=0, traced_rounds=0, traced=None)

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
            self.applied += 1

        def more():
            if until is not None:
                return self.applied < until
            return time.perf_counter() - t0 < seconds or out["attempted"] == 0

        tracing = drive.open_window() if traced_steps else None
        t0 = time.perf_counter()
        while more():
            if self.applied >= self.next_round:
                self.densify()
                out["rounds"] += 1
                out["traced_rounds"] += tracing is not None
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
        run, dev = self.run, self.run.device
        alive0 = int(self.state.params.alive.sum())  # before the clock starts
        start, first_round = self.applied, len(self.rounds_at)
        res = self.loop(run.seconds, traced_steps=run.traffic["traced_steps"] if run.traced else 0)
        alive1 = int(self.state.params.alive.sum())
        run.attempted, run.units, run.window_s = res["attempted"], res["applied"], res["seconds"]
        run.failed = res["regrows"]
        run.e2e["train_mpix_s"] = run.units * run.pixels / run.window_s / 1e6
        if res["traced"] is not None:
            run.read_trace(*res["traced"])

        counts = self.round_counts()
        in_window = counts[first_round:] if counts is not None else None
        at = [a - start for a in self.rounds_at[first_round:]]
        if in_window:  # alive over the window's steps, from the rounds' counters
            marks = [0] + at + [run.units]
            alive = [alive0] + [c["alive"] for c in in_window]
            mean = sum(a * (hi - lo) for a, lo, hi in zip(alive, marks, marks[1:]))
            self.alive_mean = mean / max(run.units, 1)
        else:  # a port without the counters
            self.alive_mean = (alive0 + alive1) / 2
        run.rounds = dict(tag=self.round.tag, count=res["rounds"], counts=in_window)
        run.notes.update(steps=run.units, regrows_in_window=res["regrows"],
                         regrown=self.regrown, captures=self.step.stats["captures"],
                         round_captures=self.round.stats["captures"], rounds_at=self.rounds_at,
                         rounds_in_window=res["rounds"], traced_rounds=res["traced_rounds"],
                         alive_window=[alive0, alive1], alive_mean=self.alive_mean,
                         round_counts=counts, allocator_window=allocator(dev))

    def round_counts(self) -> list | None:
        """The counters of every round this run made, oldest first, read
        from the port's tracer once (None where the port has none)."""
        from tpusplat_torch import trace

        if not hasattr(trace, "rounds"):
            return None
        rows = trace.rounds(self.run.device, last=len(self.rounds_at))
        return rows if len(rows) == len(self.rounds_at) else None

    def free(self):
        self.state = self.step = self.round = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, dtype=torch.float32):
        """The reference's first steps and their statistics against the
        program's, and the plain round on the program's state before the
        checked round. The result also serves in the program's place (the
        bfloat16 control): ``post`` is its round's state after."""
        run, conf, mix, dev = self.run, self.run.conf, self.run.traffic, self.run.device
        with reference.full_fp32():
            p0 = reference.cast(grow_scene(conf, run.seed, dev), dtype)
            p, st = dict(p0), reference.adam_state(p0)
            losses, pairs, grad_norms, stats = [], [], None, None
            for i in range(mix["checked_steps"]):
                cam = reference.camera(self.mats[i], dtype, dev)
                value, grads, pr = reference.train_step(p, cam, self.targets[i].to(dtype), conf,
                                                        mix["ssim_weight"])
                if i == 0:
                    grad_norms = {k: reference.norm(grads[k]) for k in reference.FIELDS}
                stats = rd.accumulate(stats, rd.step_stats(p, cam, grads, conf))
                losses.append(value)
                pairs.append(pr)
                p = reference.adam(p, grads, st, float(conf["extent"]))
            change = {k: reference.norm(p[k].float() - p0[k].float()) for k in reference.FIELDS}
            del p, p0, st, grads
            pre = cast_state(self.prog["pre"], dtype)
            g = torch.Generator(device=dev)
            g.manual_seed(int(run.seed) + NOISE_SEED)
            ref_round = rd.densify_round(pre, float(conf["extent"]), generator=g)
            del pre
        post = cast_state(ref_round["state"], torch.float32)
        ref = dict(losses=losses, grad_norms=grad_norms, change_norms=change,
                   stats_norms={f: reference.norm(stats[f]) for f in rd.STATS},
                   round=ref_round, pre=self.prog["pre"], post=post)
        if dtype == torch.float32:
            run.work.update(alive=self.alive_mean, slots=conf["gaussians"],
                            **{k: statistics.mean(pr[k] for pr in pairs) for k in pairs[0]})
            run.notes.update(checked_round=rd.counts(ref_round))
        return ref

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        """``train``'s numbers, ``stats_gap`` (the worst leaf gap of the
        statistics' norms after the checked steps) and the checked round's
        readings (``reference_densify.compare``)."""
        out = Train.compare(prog, ref)
        out["stats_gap"] = drive.leaf_gap(prog["stats_norms"], ref["stats_norms"])[0]
        out.update(rd.compare(prog["pre"], prog["post"], ref["round"]))
        return out

    def fault_program(self, ref: dict, fault: str) -> dict:
        """The program's readings' inputs with a planted fault, for the
        calibration: ``unchanged`` (the round returns its state),
        ``no_stats`` (the statistics never accumulated), or one of
        ``reference_densify.FAULTS`` (the reference's round with it)."""
        prog = self.prog
        if fault == "unchanged":
            return dict(prog, post=prog["pre"])
        if fault == "no_stats":
            return dict(prog, stats_norms={f: 0.0 for f in rd.STATS})
        run = self.run
        g = torch.Generator(device=run.device)
        g.manual_seed(int(run.seed) + NOISE_SEED)
        with reference.full_fp32():
            bad = rd.densify_round(prog["pre"], float(run.conf["extent"]), generator=g,
                                   fault=fault)
        return dict(prog, post=bad["state"])


def cast_state(state: dict, dtype) -> dict:
    """A round state with its float tensors in ``dtype`` (the same tensors
    where they are already)."""
    def cast(v):
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        return v.to(dtype) if v.is_floating_point() else v
    return {k: cast(v) for k, v in state.items()}

