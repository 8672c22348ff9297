"""Checkpoint and resume of the whole train state, in the ``.npz`` layout of
``tpusplat/train/checkpoint.py``, so that a state moves between the two
packages in both directions.

The layout is the JAX package's: ``leaf_0`` ... ``leaf_25``, the leaves of
its ``TrainState`` in the order of ``jax.tree_util.tree_flatten`` (named in
:data:`JAX_LEAVES`), and ``__treedef__``, the uint8 bytes of the ``str()``
of that state's treedef (:data:`JAX_TREEDEF`). The treedef depends on
neither the Gaussian count nor the SH degree, so the port holds it as a
constant. The dtypes are JAX's: float32, a bool ``alive``, 0-d int32 counts
and ``step``. optax keeps two counts for the means: Adam's and the learning
rate schedule's (leaf 12), which advance together; the port keeps one and
writes it into both.

The arrays are stored uncompressed: float state barely compresses, and
zlib would take most of the time of a garden-sized save. ``np.load`` reads
both forms, so a file that ``save_checkpoint`` of the JAX package wrote
(compressed) loads here too. The JAX package's directory form is Orbax, a
JAX library, and has no counterpart.

Moving a state: ``apps/train.py ... --ckpt s.npz``, then
``load_checkpoint("s.npz", like)`` here; or ``python -m
tpusplat_torch.trainer ... --ckpt s.npz``, then the JAX package's
``load_checkpoint("s.npz", like)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusplat_torch.train.step import TRAINABLE, TrainState
from tpusplat_torch.types import GaussianParams

STATS = ("step", "grad_accum", "grad_count", "max_radii")
PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianParams))
# optax's per-group dicts flatten in sorted key order.
GROUPS = tuple(sorted(TRAINABLE))

# The JAX TrainState's leaves, in file order (leaf_i is JAX_LEAVES[i]).
JAX_LEAVES = (
    "params.means", "params.log_scales", "params.quats", "params.opacities", "params.sh",
    "params.alive",
    "opt_state.log_scales.count", "opt_state.log_scales.mu", "opt_state.log_scales.nu",
    "opt_state.means.count", "opt_state.means.mu", "opt_state.means.nu",
    "opt_state.means.schedule_count",
    "opt_state.opacities.count", "opt_state.opacities.mu", "opt_state.opacities.nu",
    "opt_state.quats.count", "opt_state.quats.mu", "opt_state.quats.nu",
    "opt_state.sh.count", "opt_state.sh.mu", "opt_state.sh.nu",
    "step", "grad_accum", "grad_count", "max_radii",
)


def _jax_treedef() -> str:
    """``str(jax.tree_util.tree_structure(state))`` of the JAX package's
    ``TrainState`` under its ``make_optimizer``: ``optax.multi_transform``
    of one ``optax.adam`` a group, whose moments hold the group's own
    parameter and a ``MaskedNode`` for each other group; the means' Adam is
    followed by its learning rate schedule's state, the others' by an
    ``EmptyState``."""
    def node(name, children=""):
        return f"CustomNode({name}, [{children}])"

    def moments(group):
        return "{" + ", ".join(
            f"'{g}': " + ("*" if g == group else node("namedtuple[MaskedNode]")) for g in GROUPS
        ) + "}"

    def inner(group):
        adam = node("namedtuple[ScaleByAdamState]", f"*, {moments(group)}, {moments(group)}")
        lr = (node("namedtuple[ScaleByScheduleState]", "*") if group == "means"
              else node("namedtuple[EmptyState]"))
        return node("namedtuple[MaskedState]", f"({adam}, {lr})")

    params = node("GaussianParams[()]", ", ".join("*" * len(PARAM_FIELDS)))
    opt = node("namedtuple[PartitionState]",
               "{" + ", ".join(f"'{g}': {inner(g)}" for g in GROUPS) + "}")
    stats = ", ".join("*" * len(STATS))
    return f"PyTreeDef({node('TrainState[()]', f'{params}, {opt}, {stats}')})"


JAX_TREEDEF = _jax_treedef()


def _check_path(path) -> str:
    path = str(path)
    if not path.endswith(".npz"):
        raise ValueError(f"checkpoint path {path!r}: only the .npz form is supported")
    return path


def state_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor of ``state`` by its JAX leaf name, in file order. The
    means' count stands under both of its names."""
    out = {f"params.{f}": getattr(state.params, f) for f in PARAM_FIELDS}
    for g in GROUPS:
        out.update({f"opt_state.{g}.count": state.count[g], f"opt_state.{g}.mu": state.mu[g],
                    f"opt_state.{g}.nu": state.nu[g]})
    out["opt_state.means.schedule_count"] = state.count["means"]
    out.update({k: getattr(state, k) for k in STATS})
    return {k: out[k] for k in JAX_LEAVES}


def save_checkpoint(path, state: TrainState) -> None:
    """Write ``state`` to the ``.npz`` file ``path`` in the JAX layout."""
    path = _check_path(path)
    tensors = state_tensors(state)
    np.savez(path, __treedef__=np.frombuffer(JAX_TREEDEF.encode(), dtype=np.uint8),
             **{f"leaf_{i}": tensors[k].detach().cpu().numpy()
                for i, k in enumerate(JAX_LEAVES)})


def load_checkpoint(path, like: TrainState) -> TrainState:
    """The state saved at ``path`` (by either package), each tensor on the
    device of its counterpart in ``like``. Raises a ``ValueError`` when the
    file's leaves, treedef, shapes or dtypes differ from ``like``'s, or its
    two means counts differ."""
    path = _check_path(path)
    want = state_tensors(like)
    files = {"__treedef__", *(f"leaf_{i}" for i in range(len(JAX_LEAVES)))}
    with np.load(path) as data:
        if "params.means" in data.files:
            raise ValueError(f"{path}: the port's old named layout (params.<field>, "
                             "mu.<group>, ...); only the JAX package's leaf layout is read")
        if set(data.files) != files:
            raise ValueError(f"{path}: missing {sorted(files - set(data.files))}, "
                             f"unexpected {sorted(set(data.files) - files)}")
        treedef = data["__treedef__"].tobytes().decode(errors="replace")
        if treedef != JAX_TREEDEF:
            raise ValueError(f"{path}: the treedef is not the train state's\n"
                             f"file:  {treedef}\nstate: {JAX_TREEDEF}")
        got = {}
        for i, (k, ref) in enumerate(want.items()):
            a = data[f"leaf_{i}"]
            dtype = torch.empty((), dtype=ref.dtype).numpy().dtype
            if a.shape != tuple(ref.shape) or a.dtype != dtype:
                raise ValueError(f"{path}: leaf_{i} ({k}) has shape and dtype "
                                 f"{list(a.shape)} {a.dtype}, the state "
                                 f"{list(ref.shape)} {dtype}")
            got[k] = torch.as_tensor(a).to(ref.device)
    if not torch.equal(got["opt_state.means.schedule_count"], got["opt_state.means.count"]):
        raise ValueError(f"{path}: leaf_12 (the means' schedule count) "
                         f"{int(got['opt_state.means.schedule_count'])} differs from leaf_9 "
                         f"(their Adam count) {int(got['opt_state.means.count'])}")

    def group(part):
        return {g: got[f"opt_state.{g}.{part}"] for g in TRAINABLE}

    return TrainState(params=GaussianParams(**{f: got[f"params.{f}"] for f in PARAM_FIELDS}),
                      mu=group("mu"), nu=group("nu"), count=group("count"),
                      **{k: got[k] for k in STATS})
