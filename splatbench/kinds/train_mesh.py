"""Traffic of kind ``train_mesh``: one trainer over a ("data", "tile") mesh
of cards, a rank a card, as ``tpusplat_torch.trainer`` runs its ``--mesh``
loop once densification has ended: the state sharded over the mesh
(``sharded.shard_state``), the overlap step
(``sharded_train_step_overlap``, with the ring reduce; the configuration's
``step`` says ``"overlap"``) once a view, views round-robin on the mix's ``ring``, the
counters (summed over the mesh by the step) read one step late with
``regrow``, so that every rank regrows alike and retries the same view.

Every rank runs this generator (``ranks.py``). Nothing is exchanged in the
window but what the program exchanges: the window's step count is set
once, in set-up, by rank 0 from the warm-up's rate and shared, and every
rank attempts exactly that many steps; barriers bound the window, which
rank 0 times.

Parameters (``traffic/<mix>.json``): those of kind ``train``
(``kinds/train.py``) but ``loss_reps``; ``capacity_margin`` is over the
reference's count of the busiest strip's instances over the ring's views.
The configuration gives ``mesh`` (``data``, ``tile``), ``grad_exchange``
and ``step``.
"""

from __future__ import annotations

import collections
import dataclasses
import time

from splatbench import drive, inputs, ranks, reference

WARM_PROBE = 8  # the warm-up's first steps, untimed: first calls, allocator, cuDNN


def steps_for(seconds: float, done: dict) -> int:
    """Steps that fill ``seconds`` at the rate of a loop's result ``done``."""
    return max(1, round(seconds * done["attempted"] / max(done["seconds"], 1e-9)))


class Mix(drive.load_kind("train")):
    def setup(self):
        from tpusplat_torch.config import regrow
        from tpusplat_torch.parallel import sharded
        from tpusplat_torch.train.step import B1, TRAINABLE, create_train_state, make_optimizer

        run, conf, mix, dev = self.run, self.run.conf, self.run.traffic, self.run.device
        self.regrow = regrow
        self.mesh = ranks.mesh(conf["mesh"]["data"], conf["mesh"]["tile"])
        scene = inputs.make_scene(conf, run.seed, dev)
        self.targets = inputs.make_targets(conf, run.seed, dev)
        self.mats = inputs.training_views(conf, mix["ring"], run.seed)
        self.cams = [drive.program_camera(m, dev) for m in self.mats]
        # The capacity probe, its views shared out over the ranks.
        own = self.mats[self.mesh.rank::run.chips]
        needed = max(ranks.every(reference.strip_instances_needed(scene, own, conf)
                                 if own else 0))
        self.cfg = dataclasses.replace(drive.render_config(conf, needed * mix["capacity_margin"]),
                                       grad_exchange=conf["grad_exchange"])
        self.opt = make_optimizer(scene_extent=float(conf["extent"]))
        if conf["step"] != "overlap":
            raise ValueError(f"step {conf['step']!r}: this kind runs the overlap step alone")
        self.step = sharded.sharded_train_step_overlap
        self.state = sharded.shard_state(create_train_state(drive.program_params(scene)),
                                         self.mesh)
        n_local = self.state.params.num_gaussians
        nrows, cap = sharded.strip_geometry(n_local, conf["height"], self.cfg, self.mesh.tile)
        tiles_y = self.cfg.tile_grid(conf["width"], conf["height"])[1]
        gcap = self.cfg.strip_gauss_capacity(n_local * self.mesh.tile, nrows, tiles_y)
        run.notes.update(strip_instances_needed=needed, capacity=cap, strip_rows=nrows,
                         strip_gauss_capacity=gcap,
                         exchange="compact" if self.cfg.grad_exchange == "compact"
                         and gcap is not None else "dense")

        # The checked steps: the first steps of the state the window drives,
        # through its own call, on distinct views; the state gathered from
        # the shards (every rank takes part) after the first and the last.
        losses, gated = [], 0
        last = mix["checked_steps"] - 1
        for i in range(last + 1):
            self.state, metrics = self.take(i)
            losses.append(float(metrics["loss"]))
            gated += sum(int(metrics[k]) for k in sharded.COUNTERS) > 0
            if i in (0, last):
                whole = sharded.gather_state(self.state, self.mesh)
            if i == 0:  # the first gradient, as the optimizer got it
                grad_norms = {k: reference.norm(whole.mu[k] / (1 - B1)) for k in TRAINABLE}
        change = {k: reference.norm(getattr(whole.params, k) - scene[k]) for k in TRAINABLE}
        self.prog = dict(losses=losses, grad_norms=grad_norms, change_norms=change)
        run.notes.update(checked_steps_gated=gated)
        del scene, whole
        self.seq = mix["checked_steps"]
        self.regrown: list = []
        # The same loop, untimed, then its rate sets the window's steps
        # (rank 0's reading, shared once).
        probe = self.loop(WARM_PROBE)
        warm = self.loop(ranks.share(max(WARM_PROBE, steps_for(
            float(mix["warmup_s"]) - probe["seconds"], probe))))
        self.window_steps = ranks.share(steps_for(run.seconds, warm))
        run.notes.update(warmup_steps=probe["applied"] + warm["applied"],
                         regrows_warmup=probe["regrows"] + warm["regrows"],
                         window_steps=self.window_steps)

    def loss_span(self):
        """Not read here: the loss layer's own time is ``garden-train``'s
        (``loss_ms.train`` does not list this cell)."""

    def take(self, i: int):
        """One step of the program on view ``i``."""
        return self.step(self.state, [self.cams[i]], self.targets[i:i + 1], self.cfg, self.opt,
                         self.mesh, self.run.traffic["ssim_weight"])

    def loop(self, steps: int, traced_steps: int = 0) -> dict:
        """Exactly ``steps`` steps, round-robin over the views, a retried
        view first; barriers bound them. With ``traced_steps``, a traced
        window is open over the first that many."""
        views, dev = len(self.cams), self.run.device
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

        ranks.barrier(dev)
        tracing = drive.open_window() if traced_steps else None
        t0 = time.perf_counter()
        starts = []
        for _ in range(steps):
            starts.append(time.perf_counter())
            if retry:
                i = retry.popleft()
            else:
                i = self.seq % views
                self.seq += 1
            with drive.span("train_step"):
                self.state, metrics = self.take(i)
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
        ranks.barrier(dev)
        t1 = time.perf_counter()
        out["seconds"] = t1 - t0
        # The host's time from one step's call to the next: how evenly the
        # ranks' lockstep runs (for the notes).
        gaps = sorted(1e3 * (b - a) for a, b in zip(starts, starts[1:] + [t1]))
        out["step_ms"] = [round(gaps[int(q * (len(gaps) - 1))], 2)
                          for q in (0.1, 0.5, 0.9, 1.0)] if gaps else None
        if tracing is not None:
            drive.close_window(tracing)
            out["traced"] = (tracing, out["attempted"], t1, out["attempted"])
        if out["traced"] is not None:
            tracing, units, rest_t0, at = out["traced"]
            out["traced"] = (tracing, units, t1 - rest_t0, out["attempted"] - at)
        return out

    def window(self):
        run = self.run
        res = self.loop(self.window_steps, run.traffic["traced_steps"] if run.traced else 0)
        run.attempted, run.units, run.window_s = res["attempted"], res["applied"], res["seconds"]
        run.failed = res["regrows"]
        run.e2e["train_mpix_s"] = run.units * run.pixels / run.window_s / 1e6
        if res["traced"] is not None:
            run.read_trace(*res["traced"])
        run.notes.update(steps=run.units, regrows_in_window=res["regrows"],
                         regrown=self.regrown, step_ms_p10_p50_p90_max=res["step_ms"])
