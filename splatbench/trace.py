"""The traced window: a ``torch.profiler`` window over part of the measured
loop, reduced to what the per-layer readers take (device intervals by name,
the window, the harness's host spans) and to the result's ``breakdown``.

The profiler records CUDA activity alone, so the host runs the loop as it
does untraced: no CPU operator is recorded. The window is bounded on the
device by two marker kernels, one launched as it opens (the device idle,
after a synchronise) and one as it closes (after a synchronise), so its
length and the device intervals share the trace's clock; should the tracer
drop a marker, the first and last device records bound it instead. The harness's host
spans are taken on the host clock from the first marker's launch; a launch
reaches the device some microseconds later, far under any gap named.

Device busy time is the union of kernel and copy intervals (a copy of
``tpusplat_torch/bench/profile_detail.py``'s ``_merged_ms``), so work that
overlaps counts once; idle gaps are named after the innermost harness span
open on the host when the gap began.
"""

from __future__ import annotations

import dataclasses

import torch

import sys
import time

TOP = 10
COLLECTIVE = "nccl"  # in the name of every NCCL kernel (lower case)
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
# Host time left between the profiler's start or stop and a marker: the
# tracer drops device records that it dates outside its own window.
PAD_S = 0.02


@dataclasses.dataclass
class Trace:
    """Device activity of a traced window, in seconds from its start."""

    window_s: float
    device: list  # (name, start, end) of each kernel, copy and memset
    spans: list  # (name, start, end) of the harness's host spans
    units: int = 0  # steps or frames completed in the window
    unit_s_untraced: float | None = None  # a unit's time in the untraced rest of the run

    def busy_s(self) -> float:
        return merged(((s, e) for _, s, e in self.device), 0.0, self.window_s)

    def untraced_window_s(self) -> float | None:
        """The time the traced units take when the loop runs untraced: the
        tracer costs each graph replay about a millisecond on the host,
        which a closed loop would count as idle."""
        if self.unit_s_untraced is None or not self.units:
            return None
        return self.units * self.unit_s_untraced

    def kernel_s(self, symbol: str) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds ``symbol``."""
        hits = [e - s for name, s, e in self.device if symbol in name]
        return sum(hits), len(hits)

    def summary(self) -> dict:
        """What one rank of a run of several cards sends rank 0: the units
        traced and the busy time of its work apart from the collectives
        (NCCL's kernels, which include the time a rank waits for its peers)."""
        own = [(s, e) for name, s, e in self.device if COLLECTIVE not in name.lower()]
        return dict(units=self.units, compute_busy_s=merged(own, 0.0, self.window_s))

    def breakdown(self) -> dict:
        by_name: dict = {}
        for name, s, e in self.device:
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return dict(device_ops=[[k, v] for k, v in ops],
                    idle_gaps=[[k, v] for k, v in self.idle_gaps()])

    def idle_gaps(self) -> list:
        """The ``TOP`` longest gaps between device intervals, longest first,
        each named by the harness span open on the host when it began."""
        ivs = sorted((s, e) for _, s, e in self.device)
        gaps, cur = [], 0.0
        for s, e in ivs:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < self.window_s:
            gaps.append((cur, self.window_s))
        named = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
            open_ = [sp for sp in self.spans if sp[1] <= a < sp[2]]
            label = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "host"
            named.append((label, b - a))
        return named


def merged(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


class Window:
    """``with Window() as w:`` traces the block; ``w.span(name)`` is a host
    span inside it; ``w.read()`` afterwards gives the :class:`Trace`.
    Without a CUDA device only the host clock and the spans are read."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.spans: list = []
        self._prof = None
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])

    def _mark(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        if self.cuda:
            torch.cuda._sleep(1)
        return t

    def __enter__(self):
        if self._prof is not None:
            self._prof.__enter__()
            time.sleep(PAD_S)
        self.t0 = self._mark()
        return self

    def __exit__(self, *exc):
        self.t1 = self._mark()
        if self._prof is not None:
            torch.cuda.synchronize()
            time.sleep(PAD_S)
            self._prof.__exit__(*exc)
        return False

    def span(self, name: str):
        return _Span(self.spans, name)

    def read(self) -> Trace:
        spans = [(n, a - self.t0, b - self.t0) for n, a, b in self.spans]
        if self._prof is None:
            return Trace(window_s=self.t1 - self.t0, device=[], spans=spans)
        from torch.autograd import DeviceType

        kernels = [e for e in self._prof.events() if e.device_type == DeviceType.CUDA]
        if not kernels:
            return Trace(window_s=self.t1 - self.t0, device=[], spans=spans)
        marks = sorted(e.time_range.start for e in kernels if MARKER in e.name)
        if len(marks) >= 2:
            lo, hi = marks[0], marks[-1]
        else:  # a marker went unrecorded: the window is bounded by the device's activity
            lo = min(e.time_range.start for e in kernels)
            hi = max(e.time_range.end for e in kernels)
            print(f"splatbench: {len(marks)} of the trace's 2 marker kernels recorded; "
                  "the window runs from the first device record to the last", file=sys.stderr)
        device = []
        for e in kernels:
            if MARKER in e.name:
                continue
            s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if t > s:
                device.append((e.name, (s - lo) / 1e6, (t - lo) / 1e6))
        return Trace(window_s=(hi - lo) / 1e6, device=device, spans=spans)


class _Span:
    def __init__(self, out: list, name: str):
        self.out, self.name = out, name

    def __enter__(self):
        self.a = time.perf_counter()

    def __exit__(self, *exc):
        self.out.append((self.name, self.a, time.perf_counter()))
        return False
