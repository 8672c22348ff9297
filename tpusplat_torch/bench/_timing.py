"""What every measurement tool of the port shares (the bench modules,
``chip_smoke.py`` and ``compare_kernels.py``): the card check, the device
line, and the one set of clocks they time and profile with.

- :func:`time_ms`: a function's device time, by CUDA events over
  back-to-back calls after two warm ones; on the CPU, where the tests
  rehearse the tools at tiny sizes, the host clock.
- :func:`host_ms`: ``bench.py``'s differenced host time of one call, so
  host time the card does not hide counts; never 0 or less.
- :func:`profiled`: one ``torch.profiler`` window over some calls: its
  milliseconds, the device's busy milliseconds and each device operation's
  count and milliseconds by name. :func:`profile_window` summarises one
  (idle share, launches a call, top kernels).

Stage times are not taken here: the program stamps its own stages inside
its graphs (``tpusplat_torch.trace``). A result names its clock
(:func:`clock`), so a CPU time never stands under a device's name. A bench
module's ``main`` runs only on the card: without one it says so and
returns nonzero.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

import torch

HOST_PAIRS = 3  # differenced pairs a host_ms reading; odd, so the median is one of them
HOST_READINGS = 4  # readings, each with twice the calls of the last, before host_ms gives up
WINDOW = "window"  # the profiler's host range around the calls
COPIES = ("Memcpy", "Memset")  # device operations that are not kernels
TOP_KERNELS = 10


def require_card(what: str) -> bool:
    """True when a CUDA device is present; else a line to stderr and False."""
    if torch.cuda.is_available():
        return True
    print(f"{what}: no CUDA device; the bench measures the card and does not run on the "
          "CPU", file=sys.stderr)
    return False


def nvidia_smi() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_info(device="cuda") -> dict:
    """The device line every bench JSON carries: the card's name, count and
    ``nvidia-smi`` name and power limit; on the CPU just ``{"kind": "cpu"}``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"kind": "cpu"}
    return {"kind": torch.cuda.get_device_name(dev), "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi()}


def clock(device) -> str:
    """The clock :func:`time_ms` reads on ``device``."""
    return "cuda_events" if torch.device(device).type == "cuda" else "host"


def sync(device) -> None:
    """Wait for the card (a no-op on the CPU, whose calls are synchronous)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int = 5, warm: int = 2):
    """(mean ms of ``fn()`` over ``reps`` back-to-back calls after ``warm``
    calls, the last result). CUDA events on the current stream on the card,
    the host clock on the CPU. Two warm calls, because a call's result stays
    alive while the next call allocates its own: the second warm call makes
    the caching allocator's second block, so no ``cudaMalloc`` (which stalls
    the host, and so the events' interval) falls inside the timed calls."""
    out = None
    for _ in range(warm):
        out = fn()
    sync(device)
    if torch.device(device).type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def host_ms(fn, device, iters: int) -> float:
    """``bench.py``'s time of one call of ``fn`` (warmed by the caller), in
    ms: the host clock over a run of ``max(1, iters // 4)`` calls and over
    one of ``iters`` more, each run fenced by :func:`sync`, and ``(t_big -
    t_small) / iters``; the median of ``HOST_PAIRS`` such pairs. On a loaded
    host a pair can read 0 or less; if the median does, the reading is
    taken again with twice the calls, up to ``HOST_READINGS`` readings, and
    then it raises with both runs' times. It never returns 0 or less."""
    def run(calls):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync(device)
        return time.perf_counter() - t0

    for k in range(HOST_READINGS):
        n = iters << k
        pad = max(1, n // 4)
        pairs = []
        for _ in range(HOST_PAIRS):
            small = run(pad)
            big = run(n + pad)
            pairs.append(((big - small) / n * 1e3, small, big))
        ms, small, big = sorted(pairs)[HOST_PAIRS // 2]
        if ms > 0:
            return ms
    raise RuntimeError(
        f"host_ms: the median pair reads {ms} ms a call after {HOST_READINGS} readings; in "
        f"the last, {pad} calls took {small} s and {n + pad} calls {big} s")


def _merged_ms(intervals, lo, hi) -> float:
    """Length (ms) of the union of [start, end) us intervals clipped to
    [lo, hi)."""
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
    return busy / 1e3


@dataclasses.dataclass
class Window:
    """What one ``torch.profiler`` window over some calls saw: the last
    call's result, the window's ms on the host clock, the device's busy ms
    in it (the union of its operations' intervals), each device operation
    (kernel, copy or set) by name as ``(count, ms)``, and the operations'
    names in the order they started. On the CPU the trace holds no device
    operation."""

    out: object
    window_ms: float
    busy_ms: float
    ops: dict
    order: list = dataclasses.field(default_factory=list)

    def counts(self) -> dict:
        """Each device operation's count by name."""
        return {name: count for name, (count, _) in self.ops.items()}


def profiled(fn, device, calls: int = 1) -> Window:
    """``calls`` calls of ``fn`` inside one ``torch.profiler`` window (CPU
    and, on the card, CUDA activity), synchronised before and at its end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync(device)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = None
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(calls):
                out = fn()
            sync(device)
    events = prof.events()
    win = next(e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU)
    lo, hi = win.time_range.start, win.time_range.end
    ops: dict = {}
    spans = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name == WINDOW \
                or getattr(e, "is_user_annotation", False):
            continue
        count, ms = ops.get(e.name, (0, 0.0))
        ops[e.name] = (count + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
        spans.append((e.time_range.start, e.time_range.end, e.name))
    spans.sort()
    return Window(out, (hi - lo) / 1e3, _merged_ms([s[:2] for s in spans], lo, hi), ops,
                  [name for _, _, name in spans])


def profile_window(fn, device, steps: int = 3) -> dict:
    """:func:`profiled` over ``steps`` calls of ``fn`` (warmed by the
    caller), summarised: window ms, device-busy ms, idle share, launches a
    call and the top kernels by device time; then the same calls unprofiled
    (:func:`time_ms`), and the idle share that the window's busy time leaves
    in them. On the CPU (a rehearsal) the trace holds no device activity,
    and the result says so."""
    w = profiled(fn, device, steps)
    events = sum(count for count, _ in w.ops.values())
    out = dict(steps=steps, window_ms=w.window_ms, profiler_device_events=events)
    if not events:
        out.update(device_busy_ms=None, idle_share=None,
                   note="the profiler recorded no device activity in the window")
        return out
    # The same calls without the profiler, whose host-side recording slows
    # the dispatch and so stretches the window: the device's kernel time a
    # call over this call time estimates the idle share of a plain call.
    step_ms, _ = time_ms(fn, device, steps, 0)
    kernels = {k: v for k, v in w.ops.items() if not k.startswith(COPIES)}
    launches = sum(count for count, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    out.update(
        device_busy_ms=w.busy_ms, idle_share=1.0 - w.busy_ms / w.window_ms,
        step_ms_unprofiled=step_ms,
        idle_share_unprofiled_est=max(0.0, 1.0 - w.busy_ms / steps / step_ms),
        kernel_launches_per_step=launches / steps,
        copies_per_step=(events - launches) / steps,
        device_ms_per_step=sum(ms for _, ms in kernels.values()) / steps,
        top_kernels=[dict(name=k[:160], ms_per_step=ms / steps, calls_per_step=c / steps)
                     for k, (c, ms) in top])
    return out


def emit(result: dict, device="cuda") -> dict:
    """Print ``result`` as one JSON line after the device line."""
    import json

    line = {"device": device_info(device), **result}
    print(json.dumps(line), flush=True)
    return line
