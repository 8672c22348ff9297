"""The densify rounds of a window, read from the port's tracer: each
round's device time from its ``densify`` stamp to its ``end`` stamp inside
the round's graph replay (``tpusplat_torch.trace``), on the device clock.

The kind that runs rounds (``kinds/train_grow.py``) leaves on the run
``run.rounds``: the round's compiled object's ``tag``, the ``count`` of
rounds in the window (the latest of the tag's units, the loop ending on a
step) and their ``counts`` (the port's round counters, or None). Rounds in
the traced part of a window run under the profiler too, so a round's time
here is read whether or not it was traced. A port without the ``densify``
stamp, a run with no round in its window, or the CPU's host clock gives
nothing.
"""

from __future__ import annotations


def round_ms(run) -> list | None:
    """The device ms of each of the window's rounds, oldest first, or None."""
    rounds = getattr(run, "rounds", None)
    if rounds is None or not rounds["count"] or getattr(run, "trace", None) is None:
        return None
    try:
        import tpusplat_torch.trace as ptrace
    except ImportError:  # a port without the tracer
        return None
    stamps = ptrace.read(run.device)
    if stamps.clock != "device":
        return None
    units = stamps.units(rounds["tag"])[-rounds["count"]:]
    ms = [u.stage_ms().get("densify") for u in units]
    if len(ms) < rounds["count"] or None in ms:
        return None
    return ms
