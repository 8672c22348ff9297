"""The train step's gated Adam update on the card: the wrapper of the
kernel ``csrc/adam.cu``, which the port adds (the JAX package's update is
optax's adam, elementwise code that XLA fuses).

:func:`tpusplat_torch.train.step.apply_gradients` routes by device: a CPU
call runs the plain :func:`~tpusplat_torch.train.step.adam_update` and gates
it with ``torch.where``; every other call comes here, and the kernel gives
that plain update and its gate bit for bit on the card. One launch updates
every parameter group, reads the render's three overflow counters and each
group's count on the device, and either writes fresh buffers (an eager
step: the old state stays intact, as a JAX array does) or writes into the
state's own tensors (the body of a compiled step whose state is donated,
where the write-back then copies nothing). No call falls back to the plain
version: :func:`check_inputs` raises ``ValueError`` on what the kernel does
not take.
"""

from __future__ import annotations

import ctypes

import torch

from tpusplat_torch.ops import _build

# C calls of the kernel since the last reset, and those of them that wrote
# into their inputs (chip_smoke.py reads them).
LAUNCHES = 0
IN_PLACE_LAUNCHES = 0
MAX_GROUPS = 8  # csrc/adam.cu's kMaxGroups
# How a group's learning rate follows its count (csrc/adam.cu's kConstant,
# kDecayFloor, kDecayCeiling).
CONSTANT, DECAY_FLOOR, DECAY_CEILING = 0, 1, 2

_P = ctypes.c_void_p


class _Group(ctypes.Structure):
    """csrc/adam.cu's ``AdamGroup``."""

    _fields_ = [("p", _P), ("g", _P), ("m", _P), ("v", _P), ("p_out", _P), ("m_out", _P),
                ("v_out", _P), ("count", _P), ("numel", ctypes.c_longlong),
                ("lr", ctypes.c_float), ("lr_end", ctypes.c_float),
                ("lr_rate", ctypes.c_float), ("lr_steps", ctypes.c_int),
                ("lr_mode", ctypes.c_int)]


def _kernel():
    f = ctypes.c_float
    return _build.function("adam", "tpusplat_adam",
                           [ctypes.POINTER(_Group), ctypes.c_int, _P, _P, _P, f, f, f, f, f, _P])


def check_inputs(params: dict, grads: dict, mu: dict, nu: dict, count: dict,
                 overflow: tuple) -> None:
    """Raise ``ValueError`` unless the inputs are what the kernel takes: 1 to
    ``MAX_GROUPS`` groups, each with a gradient and both moments, all four
    contiguous float32 tensors of one shape, 16-byte aligned; each group's
    count and the three overflow counters 0-d int32; everything on one CUDA
    device."""
    if not 1 <= len(params) <= MAX_GROUPS:
        raise ValueError(f"adam kernel: 1 to {MAX_GROUPS} parameter groups, got {len(params)}")
    named = []
    for k, p in params.items():
        for what, d in (("grad", grads), ("mu", mu), ("nu", nu), ("count", count)):
            if k not in d:
                raise ValueError(f"adam kernel: no {what} for the group {k!r}")
        for what, t in (("param", p), ("grad", grads[k]), ("mu", mu[k]), ("nu", nu[k])):
            if t.dtype != torch.float32 or t.shape != p.shape or not t.is_contiguous():
                raise ValueError(f"adam kernel: {k} {what} must be contiguous float32 "
                                 f"{list(p.shape)}, got {t.dtype} {list(t.shape)}"
                                 f"{'' if t.is_contiguous() else ' not contiguous'}")
            if t.data_ptr() % 16:
                raise ValueError(f"adam kernel: {k} {what} must be 16-byte aligned")
            named.append(t)
        named.append(count[k])
    if len(overflow) != 3:
        raise ValueError(f"adam kernel: three overflow counters, got {len(overflow)}")
    for t in (*(count[k] for k in params), *overflow):
        if t.dtype != torch.int32 or t.dim() != 0:
            raise ValueError(f"adam kernel: counts and overflow counters must be 0-d int32, "
                             f"got {t.dtype} {list(t.shape)}")
    named.extend(overflow)
    devices = {t.device for t in named}
    if len(devices) > 1:
        raise ValueError("adam kernel: every tensor must lie on one device, got "
                         f"{sorted(map(str, devices))}")
    if named[0].device.type != "cuda":
        raise ValueError(f"adam kernel: no kernel for tensors on {named[0].device}")


def fused_adam(params: dict, grads: dict, mu: dict, nu: dict, count: dict, schedules: dict,
               overflow: tuple, b1: float, b2: float, eps: float, in_place: bool = False):
    """One gated Adam step of every group in one launch of the kernel:
    ``step.adam_update`` (optax's order of operations, ``schedules[k]`` the
    group's ``Optimizer.schedule``) and its ``torch.where`` gate on the
    overflow counters. The counts are read, not incremented. Returns new
    (params, mu, nu) dicts: with ``in_place``, the input tensors themselves,
    written in place (a gated step writes nothing); else fresh tensors, the
    inputs left as they were. Raises ``ValueError`` on inputs the kernel
    does not take (:func:`check_inputs`)."""
    check_inputs(params, grads, mu, nu, count, overflow)
    if in_place:
        out = (params, mu, nu)
    else:
        out = tuple({k: torch.empty_like(d[k]) for k in params} for d in (params, mu, nu))
    launch(params, grads, mu, nu, count, schedules, overflow, (b1, b2, eps), *out)
    return out


def _schedule(init: float, end: float, rate: float, steps: int) -> dict:
    """The kernel's learning-rate fields of ``Optimizer.schedule``'s tuple:
    constant where ``steps`` is 0, else the decay clamped below by ``end``
    when it falls (``rate < 1``) and above when it does not."""
    mode = CONSTANT if steps == 0 else DECAY_FLOOR if rate < 1.0 else DECAY_CEILING
    return dict(lr=init, lr_end=end, lr_rate=rate, lr_steps=steps, lr_mode=mode)


def launch(params: dict, grads: dict, mu: dict, nu: dict, count: dict, schedules: dict,
           overflow: tuple, hyper: tuple, p_out: dict, m_out: dict, v_out: dict) -> None:
    """One C call of the kernel into ``p_out``, ``m_out``, ``v_out`` on
    checked inputs, counted in ``LAUNCHES`` and, where every output is its
    input, in ``IN_PLACE_LAUNCHES``. ``hyper`` is (b1, b2, eps)."""
    global LAUNCHES, IN_PLACE_LAUNCHES
    groups = (_Group * len(params))()
    for i, (k, p) in enumerate(params.items()):
        groups[i] = _Group(*(t.data_ptr() for t in (p, grads[k], mu[k], nu[k], p_out[k],
                                                    m_out[k], v_out[k], count[k])),
                           p.numel(), **_schedule(*schedules[k]))
    b1, b2, eps = hyper
    dev = next(iter(params.values())).device
    # The Python constants as PyTorch rounds them: 1 - b1 in double, then to float.
    err = _kernel()(groups, len(params), *(t.data_ptr() for t in overflow), 1 - b1, b1,
                    1 - b2, b2, eps, _build.stream_ptr(dev))
    _build.check(err, "adam kernel")
    LAUNCHES += 1
    if all(o[k] is i[k] for o, i in ((p_out, params), (m_out, mu), (v_out, nu))
           for k in params):
        IN_PLACE_LAUNCHES += 1
