"""What every bench module shares: the card check, the device line, and the
timers.

On the card a function is timed with CUDA events over back-to-back calls
after a warm one (what ``chip_smoke.py`` does); on the CPU, where the tests
rehearse the bench functions at tiny sizes, with the host clock. A result
names its clock (``CLOCK``), so a CPU time never stands under a device's
name. A bench module's ``main`` runs only on the card: without one it
says so and returns nonzero.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch


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


def emit(result: dict, device="cuda") -> dict:
    """Print ``result`` as one JSON line after the device line."""
    import json

    line = {"device": device_info(device), **result}
    print(json.dumps(line), flush=True)
    return line
