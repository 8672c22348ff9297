"""Stall watchdog: detect a hung step (a wedged device call, a dead
collective) (counterpart of ``tpusplat/train/watchdog.py``).

A daemon thread fires if no heartbeat arrives within ``timeout_s``. In a
multi-process run, a hung collective (one process dead, the rest blocked
in an all-reduce) waits forever; the watchdog turns that into a loud,
stack-dumped exit that an orchestrator can restart from the last
checkpoint.

Usage:
    with Watchdog(timeout_s=300) as dog:
        for step in ...:
            state, metrics = train_step(...)
            int(metrics["capacity_overflow"])  # the device sync
            dog.beat(step)

On expiry the watchdog dumps every Python thread's stack to ``out`` and
runs ``on_expire``, by default ``os._exit(42)``: a blocked device call
cannot be interrupted by an exception raised in its thread, so a hard exit
with a distinctive code is the honest contract.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
import traceback


class Watchdog:
    """Heartbeat-based stall detector (daemon thread, zero steady cost)."""

    def __init__(self, timeout_s: float, on_expire=None, out=None):
        self.timeout_s = float(timeout_s)
        self._on_expire = on_expire
        self._out = out if out is not None else sys.stderr
        self._last = time.monotonic()
        self._last_step = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.expired = False

    def beat(self, step=None) -> None:
        """Record liveness; call once per completed (device-synced) step."""
        self._last = time.monotonic()
        self._last_step = step

    def _run(self) -> None:
        while not self._stop.wait(min(self.timeout_s / 4, 10.0)):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s:
                self.expired = True
                self._out.write(
                    f"watchdog: no heartbeat for {idle:.0f}s "
                    f"(last step {self._last_step}) — dumping stacks\n"
                )
                self._out.flush()
                try:
                    # Pure-Python dump (works on any stream, e.g. captured
                    # test buffers); faulthandler needs a real fd.
                    for tid, frame in sys._current_frames().items():
                        self._out.write(f"--- thread {tid} ---\n")
                        traceback.print_stack(frame, file=self._out)
                    if hasattr(self._out, "fileno"):
                        faulthandler.dump_traceback(file=self._out)
                except Exception:
                    pass
                if self._on_expire is not None:
                    self._on_expire()
                else:
                    os._exit(42)
                return

    def start(self) -> "Watchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="tpusplat-torch-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
