"""What every kind of traffic shares: one run's record, the timers, the
host spans of a traced window, the comparison by leaf norms, and the
loader that finds a kind's generator by name.

A traffic mix is a data file, ``traffic/<mix>.json``, whose ``kind`` names
the generator that reads it: ``kinds/<kind>.py``, a module with a class
``Mix``. A ``Mix`` is built on a :class:`Run` and has ``setup()``,
``window()``, ``free()``, ``loss_span()``, ``check(dtype=float32)``
(the reference's answers), ``readings(ref)`` and ``compare(prog, ref)``
(the numbers compared). From the port the harness takes only the entry
points it drives and their types.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import statistics
import sys
import time
from pathlib import Path

import torch

KINDS_DIR = Path(__file__).resolve().parent / "kinds"
_TRACING: list = [None]  # the open traced window, if any


def log(**kw):
    print(" ".join(f"{k}={v}" for k, v in kw.items()), file=sys.stderr, flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def span(name):
    """A host span of the harness, recorded while a traced window is open
    (it names the device's idle gaps) and free otherwise."""
    w = _TRACING[0]
    return w.span(name) if w is not None else contextlib.nullcontext()


def open_window():
    from splatbench.trace import Window

    w = Window().__enter__()
    _TRACING[0] = w
    return w


def close_window(w):
    w.__exit__(None, None, None)
    _TRACING[0] = None
    return w


def load_kind(kind: str):
    """The ``Mix`` class of ``kinds/<kind>.py``."""
    path = KINDS_DIR / f"{kind}.py"
    if not path.exists():
        raise SystemExit(f"splatbench: no generator {path.name} for traffic of kind {kind!r}")
    spec = importlib.util.spec_from_file_location(f"splatbench_kind_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Mix


class Timer:
    """Device time of a span: CUDA events on the card, the host clock
    after a synchronise elsewhere (the CPU rehearsal)."""

    def __init__(self, dev):
        self.dev, self.marks = dev, []

    def start(self):
        self.marks.append([self._mark(), None])

    def stop(self):
        self.marks[-1][1] = self._mark()

    def _mark(self):
        if self.dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self) -> list:
        sync(self.dev)
        if self.dev.type == "cuda":
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


@dataclasses.dataclass
class Run:
    """One run of one cell: what set-up, the window and the check found."""

    conf: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    attempted: int = 0
    failed: int = 0
    units: int = 0  # steps applied or frames completed in the window
    window_s: float = 0.0
    e2e: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)  # name -> list of ms
    work: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    notes: dict = dataclasses.field(default_factory=dict)
    chips: int = 1  # the cards the run uses, a rank each
    ranks: list = dataclasses.field(default_factory=list)  # each rank's trace summary

    @property
    def pixels(self) -> int:
        return self.conf["width"] * self.conf["height"]

    def read_trace(self, window, traced_units: int, rest_s: float, rest_units: int):
        """The traced part of the window, read once the window has closed.
        ``rest_s`` and ``rest_units`` are the host clock's time and the units
        of the untraced rest, from the trace's close on: the time a unit
        takes as the loop runs untraced, which the readers of the device's
        share take as their window."""
        self.trace = window.read()
        self.trace.units = traced_units
        self.trace.unit_s_untraced = rest_s / rest_units if rest_units > 0 else None
        self.notes.update(
            unit_ms_traced=self.trace.window_s / max(traced_units, 1) * 1e3,
            unit_ms_untraced=rest_s / rest_units * 1e3 if rest_units > 0 else None)


def render_config(conf: dict, capacity: int):
    from tpusplat_torch.config import RenderConfig

    return RenderConfig(sh_degree=conf["sh_degree"], capacity=int(capacity),
                        max_per_tile=conf["max_per_tile"], tight_radius=conf["tight_radius"])


def program_params(scene: dict):
    from tpusplat_torch.types import GaussianParams

    return GaussianParams(**scene)


def program_camera(mats: dict, dev):
    from tpusplat_torch.types import Camera

    return Camera.from_matrices(mats["view"], mats["proj"], mats["cam_pos"], mats["tan_fovx"],
                                mats["tan_fovy"], mats["width"], mats["height"], device=dev)


def leaf_gap(prog: dict, ref: dict) -> tuple[float, dict]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf. Leaves whose reference norm is under a thousandth of the median
    leaf's are left out (their change is round-off)."""
    med = statistics.median(ref.values())
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if ref[k] >= 1e-3 * med}
    return max(gaps.values()), gaps
