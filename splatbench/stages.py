"""The port's own stage times, read from its tracer (``tpusplat_torch.trace``):
the stamps its compiled steps write at their stages' starts on the device
clock, and the host spans it records at its own boundaries.

For each unit (a step's or a frame's graph replay): each stage's time, from
its stamp to the next; the gap, from one replay's ``end`` to the next
replay's first stamp (the copies out and in, and the device idle); and the
part of each gap during which the host was inside a program span, mapped
onto the device clock by the tracer's anchor (the rest of the gap the host
spent in the harness; the offset is the tracer's, interpolated to the
tail's middle between the anchors of the last capture and of the read).
Only the window's **untraced tail** counts: the last
``run.units - run.trace.units`` frames, or ``run.attempted -
run.trace.units`` steps, of the compiled step or session the window drove
(the tag of the ring's latest unit), so the numbers carry no profiler cost.

The readers report stamps on the device clock alone: on the CPU the stamps
take the host clock around the plain path, which is no device time. A port
without the tracer gives nothing. :func:`summary` also goes into the run's
notes (standard error): the gap split by the innermost program span, the
least lead of a replay's first stamp over its launch (the anchor's check),
and the traced units' stage times from the profiler's ``tpusplat_stamp_*``
records beside the ring's.
"""

from __future__ import annotations

import bisect

STAMP_PREFIX = "tpusplat_stamp_"
TOP_SPANS = 8


def summary(run) -> dict | None:
    """The tail's stage times, gaps and program share (cached on the run),
    or None where there is nothing to read."""
    t = getattr(run, "trace", None)
    if t is None or not t.units:
        return None
    if "stages" in run.notes:
        return run.notes["stages"]
    try:
        import tpusplat_torch.trace as ptrace
    except ImportError:  # a port without the tracer
        return None
    done = run.attempted if run.traffic.get("kind") == "train" else run.units
    stamps = ptrace.read(run.device)
    units = stamps.units()
    tail = units[-(done - t.units):] if done > t.units else []
    mid = (tail[0].start_ns + tail[-1].end_ns) // 2 - stamps.offset_ns if tail else 0
    out = reduce(units, ptrace.spans(), stamps.offset_at(mid), done - t.units)
    if out is not None:
        out["clock"] = stamps.clock
        out["traced"] = traced_check(units[:len(units) - (done - t.units)][-t.units:], t.device)
    run.notes["stages"] = out
    return out


def value(run, key: str):
    """One number of :func:`summary` on the device clock, or None."""
    s = summary(run)
    return s[key] if s is not None and s["clock"] == "device" else None


def stage_ms(run, stage: str):
    """One stage's ms a unit on the device clock, or None."""
    ms = value(run, "stage_ms")
    return ms.get(stage) if ms is not None else None


def reduce(units: list, spans: list, offset_ns: int, tail: int) -> dict | None:
    """The last ``tail`` units' mean stage times, gap and program share, in
    ms a unit; ``spans`` are the tracer's host spans, ``offset_ns`` the
    device clock less the host clock."""
    units = units[-tail:] if tail > 0 else []
    if len(units) < 2:
        return None
    stage_ms: dict = {}
    for u in units:
        for name, ms in u.stage_ms().items():
            stage_ms[name] = stage_ms.get(name, 0.0) + ms / len(units)
    gaps = [(a.end_ns, b.start_ns) for a, b in zip(units, units[1:])]
    lo = units[0].start_ns - offset_ns
    segs = innermost([s for s in spans if s.end_ns >= lo], offset_ns)
    starts = [a for a, _, _ in segs]
    split: dict = {}
    for a, b in gaps:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            s, e, name = segs[i]
            overlap = min(e, b) - max(s, a)
            if overlap > 0:
                split[name] = split.get(name, 0) + overlap
            i += 1
    n = len(gaps)
    top = sorted(split.items(), key=lambda kv: -kv[1])[:TOP_SPANS]
    replays = sorted(s for s, _, name in segs if name == "replay")
    leads = [u.start_ns - replays[j - 1] for u in units
             if (j := bisect.bisect_right(replays, u.start_ns)) > 0]
    return dict(
        units=len(units),
        unit_ms=(units[-1].start_ns - units[0].start_ns) / n / 1e6,
        stage_ms=stage_ms,
        gap_ms=sum(b - a for a, b in gaps) / n / 1e6,
        gap_program_ms=sum(split.values()) / n / 1e6,
        gap_split_ms={k: v / n / 1e6 for k, v in top},
        lead_min_ms=min(leads) / 1e6 if leads else None)


def innermost(spans: list, offset_ns: int) -> list:
    """The time the spans cover, on the device clock, cut into
    non-overlapping ``(start, end, name)`` pieces named by the innermost
    span open there, in order."""
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    out = []
    for s in spans:
        cur = s.start_ns
        for c in sorted(children.get(s.index, ()), key=lambda c: c.start_ns):
            if c.start_ns > cur:
                out.append((cur + offset_ns, c.start_ns + offset_ns, s.name))
            cur = max(cur, c.end_ns)
        if s.end_ns > cur:
            out.append((cur + offset_ns, s.end_ns + offset_ns, s.name))
    return sorted(out)


def traced_check(units: list, device: list) -> dict | None:
    """The traced units' mean stage times from the ring beside those from
    the profiler's stamp records (each stamp its own kernel), and the
    largest relative difference over the stages of 0.05 ms or more."""
    marks = sorted((s, name[len(STAMP_PREFIX):]) for name, s, _ in device
                   if name.startswith(STAMP_PREFIX))
    if not units or not marks:
        return None
    cupti: dict = {}
    for (t, name), (t_next, _) in zip(marks, marks[1:]):
        if name != "end":
            cupti[name] = cupti.get(name, 0.0) + (t_next - t) * 1e3
    count = sum(name == "end" for _, name in marks)
    ring: dict = {}
    for u in units:
        for name, ms in u.stage_ms().items():
            ring[name] = ring.get(name, 0.0) + ms / len(units)
    cupti = {k: v / max(count, 1) for k, v in cupti.items()}
    diffs = [abs(cupti[k] - v) / v for k, v in ring.items() if v >= 0.05 and k in cupti]
    return dict(ring_ms=ring, cupti_ms=cupti, units=len(units), cupti_units=count,
                max_rel_diff=max(diffs) if diffs else None)
