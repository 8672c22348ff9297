"""The port's tracer: stage stamps inside the compiled steps, host spans at
the program's own boundaries, and one clock for both.

**Stage stamps (device).** :func:`stage` marks where a stage of the
pipeline begins; a stage runs from its stamp to the next one. On the card
it launches a one-thread kernel (``csrc/stamp.cu``, ``tpusplat_stamp_<stage>``)
on the current stream, which writes ``%globaltimer`` and the stage into a
device ring; a capture records it into the graph like any other kernel, so
every replay stamps its stages. On the CPU it writes the host clock into a
host ring, so the CPU runs the same sequence. The stamps of a compiled step
carry its tag (:func:`new_tag`, set by :mod:`tpusplat_torch.compiled` around
the step's body), so that another graph's stamps, a densify round's or an
eval render's, never split its sequence. The orders:

- a viewer frame: preprocess, binning, blend, end;
- a training step: preprocess, binning, blend, loss, blend_bwd,
  preprocess_bwd, adam, writeback, end. ``blend_bwd`` and ``preprocess_bwd``
  are stamped in the backward pass (:func:`grad_stage`), when the gradient
  of the image and of the gathered table are ready; ``writeback`` precedes
  the copy of the donated state into its buffers;
- a surfel scene's training step (2D Gaussian Splatting): preprocess,
  binning, blend, loss, regularize, regularize_bwd, loss, blend_bwd,
  preprocess_bwd, adam, writeback, end. ``regularize`` begins the
  regularizers' forward after the photometric loss's, ``regularize_bwd``
  their backward, which autograd runs first; ``loss`` is stamped again where
  the photometric loss's backward begins, so that the loss stage holds what
  it holds in a Gaussian step;
- a densify round: densify, end.

:func:`read` synchronises once and returns the ring as :class:`Stamps`;
:meth:`Stamps.units` cuts it into the replays of one step, each with its
stages' times, and :func:`gaps` gives the time from one replay's ``end`` to
the next one's first stamp (the copies out and in, and the device idle).

**Host spans (program).** ``with span(name):`` records a name, its start and
end in ``perf_counter_ns``, its parent's index and its unit (the index of
its outermost span) into a bounded host ring that drops its oldest spans.

**One clock.** :func:`anchor` pairs ``perf_counter_ns`` with the device
clock: the least offset of a few eager anchor launches, so a host span maps
onto the device clock within a launch latency. The two clocks drift apart
by about a ppm, so every capture anchors too, and
:meth:`Stamps.offset_at` interpolates between the anchors around a moment.

**Round counters (device).** Each densify round writes its counts
(:data:`ROUND_COUNTS`: candidates, granted, cloned, split, pruned, alive
after) with :func:`count_round` into a small block on the state's device,
a ring of :data:`ROUND_RING` rows with a device-side head, so that a
compiled round writes them at every replay and nothing is read on the
host; :func:`rounds` synchronises and returns them, as :func:`read` does
the stamps.

Both halves are on by default. :data:`enabled` is read when a stamp or span
is made: set it false and new graphs hold no stamps and spans record
nothing, which is how the cost of tracing is measured; graphs captured
before keep theirs.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import dataclasses
import itertools
import time

import numpy as np
import torch

from tpusplat_torch.ops import _build

enabled = True

STAGES = ("preprocess", "binning", "blend", "loss", "blend_bwd", "preprocess_bwd", "adam",
          "writeback", "end", "densify", "regularize", "regularize_bwd")
_STAGE_ID = {name: i for i, name in enumerate(STAGES)}
RING = 1 << 16  # stamps the device ring and the host ring hold (kRing in csrc/stamp.cu)
SPAN_RING = 1 << 16  # spans the host ring holds
ANCHOR_TRIES = 5
ROUND_COUNTS = ("candidates", "granted", "cloned", "split", "pruned", "alive")
ROUND_RING = 1024  # rounds a device's counter block holds
UNTAGGED, PROFILED = 0, 1  # eager stamps; render_profiled's
_TAGS = itertools.count(2)  # compiled steps'

Span = collections.namedtuple("Span", "index name start_ns end_ns parent unit")


class _HostRings:
    """The host's rings: spans, the stack of open spans, the CPU's stamps and
    the clocks' anchors; and the round counters' block of each device."""

    def __init__(self, stamps: int = RING, spans: int = SPAN_RING):
        self.stamps = collections.deque(maxlen=stamps)  # (t_ns, stage id, tag)
        self.stamp_head = 0  # stamps ever written
        self.spans = collections.deque(maxlen=spans)  # closed Spans, oldest first
        self.open: list = []  # [index, name, start_ns, parent, unit] of each open span
        self.span_head = 0  # spans ever opened
        self.units = 0  # outermost spans ever opened
        self.anchors = collections.deque(maxlen=64)  # (host_ns, offset_ns), oldest first
        self.rounds: dict = {}  # device -> (block [ROUND_RING, counts] int64, head [1] int64)


_host = _HostRings()
_tag = [UNTAGGED]  # the tag of the stamps made now
_quiet = [False]  # true while a compiled step warms up: its eager calls are not replays
_lib = [None]


def new_tag() -> int:
    """A tag of its own for a compiled step's stamps."""
    return next(_TAGS)


@contextlib.contextmanager
def tagged(tag: int):
    """Stamps made inside carry ``tag``."""
    prev, _tag[0] = _tag[0], tag
    try:
        yield
    finally:
        _tag[0] = prev


@contextlib.contextmanager
def quiet():
    """No stamp is made inside (a compiled step's warm-up calls)."""
    prev, _quiet[0] = _quiet[0], True
    try:
        yield
    finally:
        _quiet[0] = prev


def _library():
    if _lib[0] is None:
        p, u = ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)
        stamp = _build.function("stamp", "tpusplat_trace_stamp", [ctypes.c_int, ctypes.c_uint, p])
        read = _build.function("stamp", "tpusplat_trace_read", [p, u])
        anchor_ = _build.function("stamp", "tpusplat_trace_anchor", [p, u, u])
        load = _build.function("stamp", "tpusplat_trace_load", [])
        _build.check(load(), "tpusplat_trace_load")
        _lib[0] = (stamp, read, anchor_)
    return _lib[0]


def prepare(device) -> None:
    """Load the stamp kernels for ``device`` before a capture, anchor the
    clocks and make the device's round counters (a no-op on the CPU), so
    that a capture allocates none of them."""
    if device.type == "cuda":
        anchor(device)
        _round_block(device)


def stage(name: str, device) -> None:
    """Stamp the start of stage ``name`` on ``device``'s current stream (the
    host clock on the CPU)."""
    if not enabled or _quiet[0]:
        return
    if device.type != "cuda":
        _host.stamps.append((time.perf_counter_ns(), _STAGE_ID[name], _tag[0]))
        _host.stamp_head += 1
        return
    err = _library()[0](_STAGE_ID[name], _tag[0], torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, f"stamp {name}")


class _StampGrad(torch.autograd.Function):
    """The identity; its backward stamps a stage when the gradient of its
    input is ready."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        stage(ctx.name, grad.device)
        return grad, None


def grad_stage(x, name: str):
    """``x`` itself; in the backward pass, stage ``name`` is stamped when the
    gradient of ``x`` is ready."""
    if not enabled or not x.requires_grad:
        return x
    return _StampGrad.apply(x, name)


# -- reading the stamps --


@dataclasses.dataclass
class Unit:
    """One replay of a compiled step (or one eager call): its stamps in
    order, ``(stage, t_ns)``, the last one ``end``."""

    tag: int
    marks: list

    @property
    def start_ns(self) -> int:
        return self.marks[0][1]

    @property
    def end_ns(self) -> int:
        return self.marks[-1][1]

    def stage_ms(self) -> dict:
        """Each stage's time, from its stamp to the next, in ms (a stage
        stamped twice adds up)."""
        out: dict = {}
        for (name, t), (_, t_next) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + (t_next - t) / 1e6
        return out


@dataclasses.dataclass
class Stamps:
    """The ring read at one moment, oldest first. ``clock`` is ``"device"``
    (``%globaltimer``, ns) or ``"host"`` (``perf_counter_ns``, on the CPU);
    ``offset_ns`` is the device clock less the host clock (:func:`anchor`;
    0 on the host clock). ``entries`` are ``(seq, t_ns, stage, tag)``,
    ``seq`` counting every stamp made: where the first is not 0, older
    stamps were dropped or left out, and the oldest unit of each tag may
    lack its first stamps."""

    clock: str
    offset_ns: int
    entries: list
    anchors: list = dataclasses.field(default_factory=list)  # (host_ns, offset_ns)

    def offset_at(self, host_ns: int) -> int:
        """The offset at host time ``host_ns``: interpolated between the
        anchors around it, the nearest one's outside them (``offset_ns``
        without anchors)."""
        if not self.anchors:
            return self.offset_ns
        hosts = [h for h, _ in self.anchors]
        i = bisect.bisect_right(hosts, host_ns)
        if i == 0 or i == len(hosts):
            return self.anchors[min(i, len(hosts) - 1)][1]
        (h0, o0), (h1, o1) = self.anchors[i - 1], self.anchors[i]
        return o0 + round((o1 - o0) * (host_ns - h0) / (h1 - h0))

    def last_tag(self) -> int | None:
        """The tag of the latest ``end`` stamp, or None."""
        for _, _, name, tag in reversed(self.entries):
            if name == "end":
                return tag
        return None

    def units(self, tag: int | None = None) -> list:
        """The units of ``tag`` (default: the latest unit's), oldest first:
        each runs from the first stamp after the tag's previous ``end`` to
        its next ``end``. A unit that holds the oldest entry read, where
        older stamps were dropped or left out, may lack its first stamps and
        is left out (a replay's stamps are contiguous on its stream, so no
        other unit can lack any)."""
        if tag is None:
            tag = self.last_tag()
        cut = bool(self.entries) and self.entries[0][0] > 0
        out, cur, whole = [], [], True
        for i, (_, t, name, tg) in enumerate(self.entries):
            if tg != tag:
                continue
            if not cur:
                whole = not (cut and i == 0)
            cur.append((name, t))
            if name == "end":
                if whole:
                    out.append(Unit(tag, cur))
                cur = []
        return out


def gaps(units: list) -> list:
    """The time in ms from each unit's ``end`` to the next unit's first stamp."""
    return [(b.start_ns - a.end_ns) / 1e6 for a, b in zip(units, units[1:])]


def unpack(ring, head: int, last: int | None = None) -> list:
    """The entries ``(seq, t_ns, stage, tag)`` of a device ring [n, 2]
    (time, ``(tag << 8) | stage``) after ``head`` stamps, oldest first: the
    last ``min(head, n, last)`` of them."""
    n = len(ring)
    keep = n if last is None else min(n, last)
    out = []
    for seq in range(max(0, head - keep), head):
        t, code = (int(v) for v in ring[seq % n])
        out.append((seq, t, STAGES[code & 0xFF], code >> 8))
    return out


def read(device=None, last: int | None = None) -> Stamps:
    """Synchronise, copy the ring of ``device`` (default: the current CUDA
    device, else the host's) and anchor the clocks. ``last`` keeps only
    that many of the latest stamps."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        head, ring = _host.stamp_head, list(_host.stamps)
        keep = len(ring) if last is None else min(len(ring), last)
        entries = [(head - keep + i, t, STAGES[s], tag)
                   for i, (t, s, tag) in enumerate(ring[len(ring) - keep:])]
        return Stamps("host", 0, entries)
    torch.cuda.synchronize(device)
    ring = np.zeros((RING, 2), np.uint64)
    head = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        _build.check(_library()[1](ring.ctypes.data, ctypes.byref(head)), "tpusplat_trace_read")
        offset = anchor(device)
    return Stamps("device", offset, unpack(ring, head.value, last), list(_host.anchors))


def least_offset(pairs) -> int:
    """The offset of the device clock over the host clock from ``(host_ns,
    device_ns)`` pairs, each host time taken just before a launch: the
    least difference, since a launch reaches the device a latency later."""
    return min(d - h for h, d in pairs)


def anchor(device=None, tries: int = ANCHOR_TRIES) -> int:
    """The device clock less ``perf_counter_ns``, in ns, from ``tries``
    eager anchor launches (0 on the CPU, whose stamps take the host clock)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return 0
    fn = _library()[2]
    stream = torch.cuda.current_stream(device).cuda_stream
    pairs = []
    for _ in range(tries):
        h, d = ctypes.c_ulonglong(0), ctypes.c_ulonglong(0)
        _build.check(fn(stream, ctypes.byref(h), ctypes.byref(d)), "tpusplat_trace_anchor")
        pairs.append((h.value, d.value))
    offset = least_offset(pairs)
    _host.anchors.append((pairs[0][0], offset))
    return offset


# -- round counters --


def _device_key(device) -> tuple:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device.type, device.index


def _round_block(device):
    key = _device_key(device)
    if key not in _host.rounds:
        dev = torch.device(*key)
        _host.rounds[key] = (torch.zeros((ROUND_RING, len(ROUND_COUNTS)), dtype=torch.int64,
                                         device=dev),
                             torch.zeros(1, dtype=torch.int64, device=dev))
    return _host.rounds[key]


def count_round(device, **counts) -> None:
    """Write one densify round's counts, 0-d tensors named by
    :data:`ROUND_COUNTS`, into ``device``'s counter block: device operations
    alone (the row's slot is the device-side head modulo the ring), so that
    a compiled round writes them at each replay. Nothing is written while
    tracing is off or a compiled step warms up."""
    if not enabled or _quiet[0]:
        return
    block, head = _round_block(device)
    row = torch.stack([counts[k].to(torch.int64) for k in ROUND_COUNTS])
    block.index_copy_(0, head % ROUND_RING, row[None])
    head.add_(1)


def rounds(device, last: int | None = None) -> list:
    """Synchronise and return the counts of the rounds ``device`` has
    written, oldest first, each a dict of :data:`ROUND_COUNTS` and ``round``
    (its number on the device, from 0): the last ``min(written,
    ROUND_RING, last)`` of them."""
    key = _device_key(device)
    if key not in _host.rounds:
        return []
    block, head = _host.rounds[key]
    if key[0] == "cuda":
        torch.cuda.synchronize(key[1])
    n = int(head[0])
    rows = block.cpu().tolist()
    keep = min(n, ROUND_RING) if last is None else min(n, ROUND_RING, last)
    return [dict(zip(ROUND_COUNTS, rows[seq % ROUND_RING]), round=seq)
            for seq in range(n - keep, n)]


# -- host spans --


class _Open:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        h = _host
        parent = h.open[-1] if h.open else None
        if parent is None:
            unit = h.units
            h.units += 1
        else:
            unit = parent[4]
        h.open.append([h.span_head, self.name, time.perf_counter_ns(),
                       -1 if parent is None else parent[0], unit])
        h.span_head += 1

    def __exit__(self, *exc):
        h = _host
        index, name, start, parent, unit = h.open.pop()
        h.spans.append(Span(index, name, start, time.perf_counter_ns(), parent, unit))
        return False


_NULL = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` records a host span (nothing when tracing is
    off). Spans nest in the thread that opens them."""
    return _Open(name) if enabled else _NULL


def spans() -> list:
    """The closed spans the ring holds, oldest first."""
    return list(_host.spans.copy())


def recent(n: int = 32) -> list:
    """The last ``n`` closed spans and every open one, as lines of text,
    oldest first (for a stall report: it reads no device state)."""
    closed = list(_host.spans.copy())[-n:]
    still = list(_host.open)
    lines = [f"span {s.index} {s.name} unit {s.unit} parent {s.parent} "
             f"{(s.end_ns - s.start_ns) / 1e6:.3f} ms" for s in closed]
    now = time.perf_counter_ns()
    lines += [f"span {i} {name} unit {unit} parent {parent} open for "
              f"{(now - start) / 1e6:.3f} ms" for i, name, start, parent, unit in still]
    return lines
