"""Steps captured once at their static shapes and replayed: the port's
counterpart of ``partial(jax.jit, static_argnames=...)``.

The JAX package compiles each entry point once for each set of static
arguments and shapes and replays the compiled program (``config.py``: "changing
a field re-compiles, exactly like the reference re-records command buffers on
resize"). :func:`compile_step` gives the port the same contract on the card:

- **The key** holds the static arguments (hashable: ``RenderConfig`` and
  ``Optimizer`` are frozen dataclasses) and, for every tensor leaf of the
  other arguments (walked through dataclasses such as ``GaussianParams``,
  ``Camera`` and ``TrainState``, dicts, lists and tuples), its shape, dtype
  and device; any other leaf, such as ``Camera.width``, is static too. So is
  whether gradients are enabled.
- **A new key is captured** at its first call: the step runs on copies of
  the inputs (its static input buffers), twice on a side stream to warm up
  (cuDNN's plans, the kernels' libraries and attributes), then once more on
  that stream between ``CUDAGraph.capture_begin`` and ``capture_end``, into
  a private memory pool. Nothing empties the caching allocator, as
  ``torch.cuda.graph`` would: the blocks that eager code cached stay
  cached, and the next eager call finds them, as a ``jax.jit`` compile
  frees no live buffer. The side stream is one for each device, shared by
  every compiled step, so that each capture's warm-ups reuse the blocks
  the last ones freed (the allocator keeps a freed block for the stream
  that used it).
- **Every call** copies each tensor input into its static buffer and
  replays the graph. An input is not copied when it is its static buffer
  (the same ``data_ptr``), or when it is the very tensor last copied into
  that buffer and has not been written since (its version counter is
  unchanged; a replay counts as a write of the buffers it updates).
- **What comes back**: a donated argument (``donate={"state": 0}``: the
  argument ``state``, whose new value is element 0 of the returned tuple) is
  updated in place in its static buffers, inside the graph, and those
  buffers are returned, as ``donate_argnames`` lets XLA reuse a train state's
  buffers. While the captured body runs, :func:`donated` names those
  buffers, so the step may write a new value straight into its buffer (the
  train step's Adam kernel does); the write-back then skips it. The next
  step with that state copies nothing; the state a caller held before is
  overwritten. Every other tensor of the result is copied out
  of the graph's memory, so that it stays as it was when the next call
  replays, as a JAX array does.
- **Old keys are freed**: each compiled step keeps its ``KEEP`` most recently
  used entries and drops the others. A regrown configuration does not come
  back. An entry holds its graph's pool and its static input buffers, a copy
  of every tensor input (a renderer's holds a copy of the scene's
  parameters), until it is dropped, its step is cleared or the caller lets
  go of its step: the caller owns the memory, as it owns the step.

**Tracing** (:mod:`tpusplat_torch.trace`). The body stamps ``writeback``
before it copies a donated argument's new value into its buffers, and
``end`` last, and every stamp inside carries the step's ``tag``; the
warm-up calls stamp nothing, so the stamps of a step are those of its
replays. A call records the host spans ``compiled:<fn>`` and, inside it,
``key`` (bind, flatten, hash), ``capture``, ``copy_in``, ``replay`` (the
launch) and ``copy_out`` (the result's copies).

**Launch counts.** A kernel wrapper adds one to its counter each time it
launches its kernel: the warm-up calls launch, and the captured call
launches into the graph. A replay runs no wrapper, so it adds nothing to
the counters; the kernels it runs are read, by name, from a profiler's
trace of the device.

On the CPU the same object runs without a graph: the capture runs the step
on the static buffers, and a replay runs it again there and copies its
outputs into the first run's, so the keys, copies, donation and copy-out are
those of the card. The route follows the tensors' device, as every kernel
wrapper's does. On the card a capture that fails raises; nothing falls back
to running eagerly.

The step must be a function of its arguments: no host read of a tensor's
value (it would become a constant of the graph), no copy from the host, no
write into its inputs but a donated buffer that :func:`donated` names.
Gradients do not flow back into the inputs.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import inspect
import time
import weakref

import torch

from tpusplat_torch import trace

KEEP = 2  # entries a compiled step keeps
WARMUP_CALLS = 2  # eager calls on a side stream before a capture
_SIDE_STREAMS: dict = {}  # device index -> the stream every capture there warms up on
_DONATED: set = set()  # ids of the donated buffers of the body that is running


def donated(t: torch.Tensor) -> bool:
    """Whether ``t`` is a donated input buffer of the compiled step whose
    body is running: the step may write its new value into it in place, as
    the body's write-back copies nothing into a buffer that is its own new
    value. False in the warm-up calls before a capture (their writes would
    land in the buffers the capture starts from) and outside any body."""
    return id(t) in _DONATED


@contextlib.contextmanager
def _donating(buffers):
    ids = {id(t) for t in buffers}
    _DONATED.update(ids)
    try:
        yield
    finally:
        _DONATED.difference_update(ids)


def _side_stream(device: torch.device):
    if device.index not in _SIDE_STREAMS:  # a tensor's device: its index is set
        _SIDE_STREAMS[device.index] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device.index]


def flatten(x, leaves: list):
    """Append the tensor leaves of ``x`` to ``leaves`` and return its
    structure, hashable: dataclass instances, dicts, lists and tuples are
    walked; any other value is part of the structure."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return None
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x), tuple((f.name, flatten(getattr(x, f.name), leaves))
                               for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return (dict, tuple((k, flatten(v, leaves)) for k, v in x.items()))
    if type(x) in (list, tuple):
        return (type(x), tuple(flatten(v, leaves) for v in x))
    return ("value", x)


def unflatten(struct, leaves):
    """The inverse of :func:`flatten`, taking the tensors from the iterator
    ``leaves``."""
    if struct is None:
        return next(leaves)
    kind, body = struct
    if kind == "value":
        return body
    if kind is dict:
        return {k: unflatten(s, leaves) for k, s in body}
    if kind in (list, tuple):
        return kind(unflatten(s, leaves) for s in body)
    obj = kind.__new__(kind)  # a dataclass, frozen or not, without __post_init__
    for name, s in body:
        object.__setattr__(obj, name, unflatten(s, leaves))
    return obj


def _clone_tree(x):
    leaves = []
    struct = flatten(x, leaves)
    return unflatten(struct, iter([t.clone() for t in leaves]))


def _version(t: torch.Tensor):
    """The version counter of ``t``; None for an inference tensor, which has
    none."""
    return None if t.is_inference() else t._version


class _Entry:
    """One captured key: the static input buffers, the graph (None on the
    CPU) and the outputs it writes."""

    def __init__(self, step: "CompiledStep", static: dict, structs: dict, leaves: list):
        # the step's parts, not the step: an entry holding its step would make
        # a cycle, and a step dropped by its owner would keep its graphs until
        # the garbage collector ran
        self.fn, self.donate, self.stats, self.name, self.tag = step.fn, step.donate, \
            step.stats, step.__name__, step.tag
        self.static, self.structs = static, structs
        self.inputs = [t.detach().clone() for t in leaves]
        self.sources = [None] * len(leaves)  # (weakref, version) of the last copy's source
        for i, t in enumerate(leaves):
            self._record(i, t)
        self.ranges, lo = {}, 0
        for name, (_, count) in structs.items():
            self.ranges[name] = (lo, lo + count)
            lo += count
        self.donated = set()
        for name in self.donate:
            self.donated.update(range(*self.ranges[name]))
        self.device = leaves[0].device if leaves else torch.device("cpu")
        self.graph = None

    def args(self) -> dict:
        it = iter(self.inputs)
        return {**{name: unflatten(s, it) for name, (s, _) in self.structs.items()},
                **self.static}

    def body(self):
        """The step on the static buffers, then each donated argument's new
        value written into its buffers, stamped with the step's tag."""
        with trace.tagged(self.tag):
            with _donating(self.inputs[i] for i in self.donated):
                out = self.fn(**self.args())
            if self.donate:
                trace.stage("writeback", self.device)
            for name, idx in self.donate.items():
                new = []
                flatten(out[idx], new)
                lo, hi = self.ranges[name]
                for buf, t in zip(self.inputs[lo:hi], new):
                    if t is not buf:
                        buf.copy_(t)
            trace.stage("end", self.device)
        return out

    def _kept(self, out):
        """The result without its donated elements (returned as the buffers)."""
        if not self.donate:
            return out
        return tuple(None if i in self.donate.values() else v for i, v in enumerate(out))

    def _check_donation(self, out):
        """The new value of each donated argument is shaped like it."""
        for name, idx in self.donate.items():
            new = []
            struct = flatten(out[idx], new)
            lo, hi = self.ranges[name]
            if struct != self.structs[name][0] or any(
                    (t.shape, t.dtype) != (b.shape, b.dtype)
                    for t, b in zip(new, self.inputs[lo:hi])):
                raise ValueError(f"{self.name}: element {idx} of the result is not "
                                 f"shaped like the donated argument {name!r}")

    def capture(self):
        """Capture the step (on the card) or run it once (on the CPU); the
        first run's outputs are the ones every replay writes."""
        out = self.body() if self.device.type != "cuda" else self._capture_graph()
        self._check_donation(out)
        self.out = self._kept(out)
        self.out_leaves = []
        flatten(self.out, self.out_leaves)

    def warm_up(self):
        """The step's eager calls on the static buffers before a capture:
        unstamped, their results dropped, and no buffer marked donated, so
        the buffers the capture starts from stay as they were."""
        with trace.quiet():
            for _ in range(WARMUP_CALLS):
                self.fn(**self.args())

    def _capture_graph(self):
        with torch.cuda.device(self.device):
            trace.prepare(self.device)
            main, side = torch.cuda.current_stream(self.device), _side_stream(self.device)
            side.wait_stream(main)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                self.warm_up()
                graph.capture_begin(pool=torch.cuda.graph_pool_handle())
                try:
                    out = self.body()
                finally:
                    graph.capture_end()
            main.wait_stream(side)
            self.graph = graph
            return out

    def copy_in(self, leaves):
        stats = self.stats
        for i, (buf, t) in enumerate(zip(self.inputs, leaves)):
            if t.data_ptr() == buf.data_ptr() and t.stride() == buf.stride():
                stats["copies_skipped"] += 1
                continue
            src = self.sources[i]
            if i not in self.donated and src is not None and src[0]() is t \
                    and _version(t) == src[1]:
                stats["copies_skipped"] += 1
                continue
            buf.copy_(t)
            stats["copies_in"] += 1
            self._record(i, t)

    def _record(self, i, t):
        v = _version(t)
        self.sources[i] = None if v is None else (weakref.ref(t), v)

    def replay(self):
        if self.graph is None:
            out = self._kept(self.body())
            new = []
            flatten(out, new)
            for s, t in zip(self.out_leaves, new):
                if s is not t:
                    s.copy_(t)
        else:
            with torch.cuda.device(self.device):
                self.graph.replay()
            for i in self.donated:  # written by the graph, outside autograd's view
                if not self.inputs[i].is_inference():
                    torch.autograd.graph.increment_version(self.inputs[i])
        self.stats["replays"] += 1

    def result(self):
        if not self.donate:
            return _clone_tree(self.out)
        out = list(self.out)
        for name, idx in self.donate.items():
            lo, hi = self.ranges[name]
            out[idx] = unflatten(self.structs[name][0], iter(self.inputs[lo:hi]))
        return tuple(v if i in self.donate.values() else _clone_tree(v)
                     for i, v in enumerate(out))

    def close(self):
        graph = self.graph
        self.graph = self.out = self.inputs = self.out_leaves = None  # the pool's tensors
        if graph is not None:
            graph.reset()


class CompiledStep:
    """``fn`` captured once per key and replayed (the module docstring says
    how); called like ``fn``. ``stats`` counts captures, replays (the first
    call's included), evictions, inputs copied in and copies skipped, and the
    seconds of the captures (warm-up included). ``tag`` marks the stamps of
    its replays (:mod:`tpusplat_torch.trace`)."""

    def __init__(self, fn, static_argnames=(), donate=None):
        self.fn = fn
        self.__name__ = getattr(fn, "__name__", "step")
        self.__doc__ = fn.__doc__
        self.signature = inspect.signature(fn)
        self.static_argnames = tuple(static_argnames)
        self.donate = dict(donate or {})
        unknown = set(self.static_argnames) | set(self.donate)
        unknown -= set(self.signature.parameters)
        if unknown:
            raise ValueError(f"{self.__name__} has no argument {sorted(unknown)}")
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.stats = collections.Counter(capture_s=0.0)
        self.tag = trace.new_tag()
        self._span = f"compiled:{self.__name__}"

    def __len__(self) -> int:
        return len(self._entries)

    def __call__(self, *args, **kwargs):
        with trace.span(self._span):
            with trace.span("key"):
                bound = self.signature.bind(*args, **kwargs)
                bound.apply_defaults()
                static = {k: bound.arguments[k] for k in self.static_argnames}
                structs, leaves = {}, []
                for name, v in bound.arguments.items():
                    if name not in static:
                        n = len(leaves)
                        structs[name] = (flatten(v, leaves), len(leaves) - n)
                devices = {t.device for t in leaves}
                if len(devices) > 1:
                    raise ValueError(f"{self.__name__}: tensors on more than one device: "
                                     f"{sorted(map(str, devices))}")
                key = (tuple(static.items()), tuple((k, s) for k, (s, _) in structs.items()),
                       tuple((tuple(t.shape), t.dtype, t.device) for t in leaves),
                       torch.is_grad_enabled())
                entry = self._entries.get(key)
            if entry is None:
                with trace.span("capture"):
                    while len(self._entries) >= KEEP:
                        self._entries.popitem(last=False)[1].close()
                        self.stats["evictions"] += 1
                    t0 = time.perf_counter()
                    entry = _Entry(self, static, structs, leaves)
                    entry.capture()
                    self._entries[key] = entry
                    self.stats["captures"] += 1
                    self.stats["capture_s"] += time.perf_counter() - t0
                if entry.graph is not None:
                    with trace.span("replay"):
                        entry.replay()
                else:
                    self.stats["replays"] += 1  # the capture's run was the first replay
            else:
                self._entries.move_to_end(key)
                with trace.span("copy_in"):
                    entry.copy_in(leaves)
                with trace.span("replay"):
                    entry.replay()
            with trace.span("copy_out"):
                return entry.result()

    def clear(self) -> None:
        """Drop every entry: graphs, pools and buffers."""
        while self._entries:
            self._entries.popitem(last=False)[1].close()


def compile_step(fn, static_argnames=(), donate=None) -> CompiledStep:
    """``fn`` compiled as ``jax.jit(fn, static_argnames=...)`` compiles it:
    captured once per key as a CUDA graph on the card and replayed.
    ``donate`` maps an argument's name to the index, in the tuple ``fn``
    returns, of its new value, which is written back into that argument's
    buffers."""
    return CompiledStep(fn, static_argnames, donate)
