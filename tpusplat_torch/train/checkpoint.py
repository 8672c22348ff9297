"""Checkpoint and resume of the whole train state (counterpart of
``tpusplat/train/checkpoint.py``, its ``.npz`` form).

A checkpoint is one ``.npz`` with a named array per tensor of the
:class:`~tpusplat_torch.train.step.TrainState`: ``params.<field>`` (the
five trainable fields and ``alive``), ``mu.<group>``, ``nu.<group>`` and
``count.<group>`` for Adam, ``step``, ``grad_accum``, ``grad_count`` and
``max_radii``. The JAX package's directory form is Orbax, a JAX library,
and has no counterpart. The arrays are stored uncompressed: float state
barely compresses, and zlib would take most of the time of a garden-sized
save.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusplat_torch.train.step import TrainState
from tpusplat_torch.types import GaussianParams

STATS = ("step", "grad_accum", "grad_count", "max_radii")


def _check_path(path) -> str:
    path = str(path)
    if not path.endswith(".npz"):
        raise ValueError(f"checkpoint path {path!r}: only the .npz form is supported")
    return path


def state_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor of ``state`` by its checkpoint key."""
    out = {f"params.{f.name}": getattr(state.params, f.name)
           for f in dataclasses.fields(GaussianParams)}
    for group in ("mu", "nu", "count"):
        out.update({f"{group}.{k}": v for k, v in getattr(state, group).items()})
    out.update({k: getattr(state, k) for k in STATS})
    return out


def save_checkpoint(path, state: TrainState) -> None:
    """Write ``state`` to the ``.npz`` file ``path``."""
    path = _check_path(path)
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state_tensors(state).items()})


def load_checkpoint(path, like: TrainState) -> TrainState:
    """The state saved at ``path``, each tensor on the device and in the
    dtype of its counterpart in ``like``. Raises if the keys or shapes
    differ from ``like``'s."""
    path = _check_path(path)
    want = state_tensors(like)
    with np.load(path) as data:
        if set(data.files) != set(want):
            raise ValueError(f"{path}: keys {sorted(set(data.files) ^ set(want))} differ "
                             "from the train state's")
        got = {}
        for k, ref in want.items():
            a = data[k]
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"{path}: {k} has shape {a.shape}, the state "
                                 f"{tuple(ref.shape)}")
            got[k] = torch.as_tensor(a).to(device=ref.device, dtype=ref.dtype)

    def group(name):
        return {k.split(".", 1)[1]: v for k, v in got.items() if k.startswith(name + ".")}

    return TrainState(params=GaussianParams(**group("params")), mu=group("mu"),
                      nu=group("nu"), count=group("count"), **{k: got[k] for k in STATS})
