"""Traffic of kind ``view``: one viewer, closed loop. Each frame sets the
next pose of the mix's ``orbit`` on a ``Session`` (``position``,
``rotation``), calls ``Session.draw()`` and synchronises; its latency runs
from the pose set to the synchronise. Set-up walks the orbit once, so that
``render_auto``'s regrows and captures are paid there.

Parameters (``traffic/<mix>.json``): ``orbit`` (``radius`` [at angle 0,
at half a turn], ``height``, ``poses_per_rev``), ``capacity_margin`` (over
the reference's count of the first pose's instances), ``warmup_s`` (the
loop run untimed at the end of set-up), ``checked_frames``
(frames kept for the check, drawn from the seed), ``traced_frames`` (the
traced part of a ``--trace 1`` window).
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import time

import torch

from splatbench import drive, inputs, reference


class Mix:
    def __init__(self, run: drive.Run):
        self.run = run

    def setup(self):
        from tpusplat_torch.session import Session, SessionConfig

        run, conf, mix, dev = self.run, self.run.conf, self.run.traffic, self.run.device
        scene = inputs.make_scene(conf, run.seed, dev)
        self.poses = inputs.orbit_poses(mix["orbit"])
        first = inputs.pose_matrices(conf, self.poses[0])
        needed = reference.instances_needed(scene, [first], conf)
        cfg = drive.render_config(conf, needed * mix["capacity_margin"])
        self.session = Session(SessionConfig(width=conf["width"], height=conf["height"],
                                             fov=conf["fov"], render=cfg),
                               params=drive.program_params(scene), device=dev)
        del scene
        self.session.initialize()
        # One revolution: the regrows and captures of render_auto are paid here.
        t0 = time.perf_counter()
        for pose in self.poses:
            self._draw(pose)
        drive.sync(dev)
        walk_s = (time.perf_counter() - t0) / len(self.poses)
        run.notes.update(instances_needed=needed, capacity_first=cfg.capacity,
                         capacity=self.session.config.render.capacity,
                         regrows_setup=int(self.session.config.render is not cfg),
                         walk_ms=walk_s * 1e3)
        self.keep_p = min(1.0, mix["checked_frames"] / max(1.0, run.seconds / walk_s))
        # The window's loop, untimed: clocks and caches settle before it.
        t0, k = time.perf_counter(), 0
        while time.perf_counter() - t0 < float(mix["warmup_s"]):
            self._draw(self.poses[k % len(self.poses)])
            drive.sync(dev)
            k += 1
        run.notes.update(warmup_frames=k)

    def _draw(self, pose):
        self.session.position, self.session.rotation = pose[0].copy(), pose[1].copy()
        return self.session.draw()

    def window(self):
        run, dev = self.run, self.run.device
        rng = random.Random(run.seed)
        lat, kept = [], []
        cfg0 = self.session.config.render
        k = 0
        tracing = drive.open_window() if run.traced else None
        traced = None
        last = None
        t0 = time.perf_counter()
        while True:
            ta = time.perf_counter()
            if ta - t0 >= run.seconds and k > 0:
                break
            pose = self.poses[k % len(self.poses)]
            with drive.span("draw"):
                img, aux = self._draw(pose)
                drive.sync(dev)
            lat.append(time.perf_counter() - ta)
            run.attempted += 1
            run.failed += int(aux["capacity_overflow"]) > 0
            last = (k, img)
            if rng.random() < self.keep_p:
                kept.append(last)
            k += 1
            if tracing is not None and k >= run.traffic["traced_frames"]:
                drive.close_window(tracing)
                traced, tracing = (tracing, k, time.perf_counter()), None
        t1 = time.perf_counter()
        run.window_s = t1 - t0
        if tracing is not None:
            drive.close_window(tracing)
            traced = (tracing, k, t1)
        run.units = k
        if last is not None and (not kept or kept[-1][0] != last[0]):
            kept.append(last)
        self.kept = kept
        run.e2e["frame_ms"] = run.window_s / k * 1e3
        run.e2e["frame_p95_ms"] = statistics.quantiles(lat, n=100)[94] * 1e3 if k > 1 \
            else lat[0] * 1e3
        if traced is not None:
            tracing, units, rest_t0 = traced
            run.read_trace(tracing, units, t1 - rest_t0, k - units)
        run.notes.update(frames=k, checked_frames=len(kept),
                         regrows_in_window=int(self.session.config.render is not cfg0))

    def free(self):
        self.session = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def loss_span(self):
        """A viewer's frame has no loss layer."""

    def check(self, dtype=torch.float32):
        """The reference's frames of the kept poses."""
        run, conf, dev = self.run, self.run.conf, self.run.device
        out, pairs = {}, []
        with reference.full_fp32():
            p = reference.cast(inputs.make_scene(conf, run.seed, dev), dtype)
            for k, _ in self.kept:
                mats = inputs.pose_matrices(conf, self.poses[k % len(self.poses)])
                img, pr = reference.frame(p, reference.camera(mats, dtype, dev), conf)
                out[k] = img.float()
                pairs.append(pr)
        if dtype == torch.float32:
            run.work.update(alive=conf["gaussians"],
                            **{k: statistics.mean(pr[k] for pr in pairs) for k in pairs[0]})
        return out

    def readings(self, ref: dict) -> dict:
        return self.compare(dict(self.kept), ref)

    @staticmethod
    def compare(frames: dict, ref: dict) -> dict:
        """The worst frame's median pixel error, and the worst 16x16 tile's
        RMS error over the frames."""
        med, tile = 0.0, 0.0
        for k, img in frames.items():
            err = (img.float() - ref[k]).abs()
            med = max(med, float(err.median()))
            h, w = err.shape[:2]
            e2 = torch.nn.functional.pad(err * err, (0, 0, 0, -w % 16, 0, -h % 16))
            ms = e2.reshape(e2.shape[0] // 16, 16, e2.shape[1] // 16, 16, 3).mean(dim=(1, 3, 4))
            tile = max(tile, math.sqrt(float(ms.max())))
        return dict(pixel_median_err=med, tile_rms_max=tile)
