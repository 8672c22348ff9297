"""Adaptive density control: clone / split / prune under a static capacity
(counterpart of ``tpusplat/train/densify.py``).

The Gaussian count never changes: the parameter tensors have a fixed
capacity N and an ``alive`` mask; dead slots render as fully transparent.
Densification grants free slots to the candidates with the largest average
positional gradient, pruning frees them, and the Adam moments of every
touched slot are zeroed. Shapes stay fixed, nothing is read on the host and
nothing is copied from it, as under ``jax.jit``: every scatter writes all N
rows, a row that is not granted to index N, a drop row, as the JAX round's
``.at[target].set(..., mode="drop")`` does. :func:`compile_densify` is the
round as ``apps/train.py`` jits it.

Recipe (upstream 3DGS semantics, as in the JAX package):
  * candidates: average positional-gradient norm >= grad_threshold, alive;
  * clone (scale small): copy the Gaussian into a free slot;
  * split (scale large): two samples from the Gaussian, scale / 1.6 -- one
    replaces the source slot, one takes a free slot;
  * prune: opacity below min_opacity (plus the optional size caps).

Each round writes its counts (candidates, granted, cloned, split, pruned,
alive after) into the tracer's round counters (``trace.count_round``), on
the device; the compiled round also stamps ``densify`` at its start.

The split noise is drawn from a key of ``jax.random``'s threefry stream
(``tpusplat_torch.train.prng``), as the JAX package draws it, so the same
key gives the same split positions; ``noise``/``noise2`` may be passed
instead.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import torch

from tpusplat_torch import trace
from tpusplat_torch.compiled import compile_step
from tpusplat_torch.ops.activations import normalize_quat
from tpusplat_torch.train import prng
from tpusplat_torch.train.step import TrainState
from tpusplat_torch.types import GaussianParams, SurfelParams


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 2e-4
    percent_dense: float = 0.01
    min_opacity: float = 0.005
    split_scale_div: float = 1.6
    max_screen_radius: float = 0.0  # 0 disables screen-size pruning
    max_world_scale: float = 0.1  # fraction of scene extent; 0 disables


def _rot_apply(quats: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate [N, 3] vectors by [N, 4] (w, x, y, z) quaternions."""
    q = normalize_quat(quats)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    rx = (1 - 2 * (y * y + z * z)) * vx + 2 * (x * y - z * w) * vy + 2 * (x * z + y * w) * vz
    ry = 2 * (x * y + z * w) * vx + (1 - 2 * (x * x + z * z)) * vy + 2 * (y * z - x * w) * vz
    rz = 2 * (x * z - y * w) * vx + 2 * (y * z + x * w) * vy + (1 - 2 * (x * x + y * y)) * vz
    return torch.stack([rx, ry, rz], dim=-1)


def _zero_rows(moments: dict, mask: torch.Tensor) -> dict:
    """Zero the rows of every [N, ...] moment where ``mask`` is True."""
    n = mask.shape[0]
    return {k: torch.where(mask.reshape((n,) + (1,) * (v.dim() - 1)), 0.0, v)
            for k, v in moments.items()}


def _scatter(dst: torch.Tensor, target: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.at[target].set(src, mode="drop")``: a copy of ``dst`` with row
    ``target[i]`` set to ``src[i]``, where ``target[i] == n`` (the row count)
    drops. The copy has one more row, the drop row, which takes every
    dropped write and is cut off; the other targets are unique, so each kept
    row is written once at most and the result does not depend on the
    order of the writes."""
    n = dst.shape[0]
    out = dst.new_empty((n + 1, *dst.shape[1:]))
    out[:n] = dst
    return out.index_copy_(0, target, src)[:n]


def _log_f32(x: float) -> float:
    """The f32 log of ``x`` rounded to f32, as a Python float: the constant
    that XLA folds ``jnp.log(x)`` to in the jitted round. Computed on the
    host, so the round copies nothing from it."""
    def f32(v):
        return struct.unpack("<f", struct.pack("<f", v))[0]
    return f32(math.log(f32(x)))


def refuse_surfels(state: TrainState) -> None:
    """Raise ``TypeError`` for a surfel scene: 2D Gaussian Splatting's
    densification (its clone and split of disks) is not ported."""
    if isinstance(state.params, SurfelParams):
        raise TypeError("densify: a surfel scene (SurfelParams) is not densified; "
                        "train it with densification off (--densify-every 0)")


@torch.no_grad()
def densify_and_prune(
    state: TrainState,
    key: prng.Key,
    dcfg: DensifyConfig,
    scene_extent: float,
    noise: torch.Tensor | None = None,
    noise2: torch.Tensor | None = None,
) -> TrainState:
    """One densification round. ``key`` is a host key or a key tensor
    (``prng.key_tensor``) on the state's device. ``noise``/``noise2``
    ([N, 3]) are the two standard-normal split draws; when not given, they
    are ``jax.random.normal`` of ``key`` and of ``fold_in(key, 1)``, on the
    state's device."""
    refuse_surfels(state)
    params = state.params
    n = params.num_gaussians
    dev = params.device
    alive = params.alive

    avg_grad = state.grad_accum / torch.clamp_min(state.grad_count, 1.0)
    scales = torch.exp(params.log_scales)
    max_scale = scales.max(dim=-1).values

    grad_ok = (avg_grad >= dcfg.grad_threshold) & alive
    is_large = max_scale > dcfg.percent_dense * scene_extent
    cand = grad_ok
    split_m = grad_ok & is_large

    # Rank candidates by gradient, grant free slots to the top ones.
    free = ~alive
    n_free = free.sum()
    score = torch.where(cand, avg_grad, -math.inf)
    order = torch.argsort(-score, stable=True)  # candidate slots, best first
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev)
    granted = cand & (rank < n_free)

    # The j-th granted candidate (by rank) gets the j-th free slot (ascending);
    # every other slot targets n, the drop row.
    free_list = torch.argsort((~free).to(torch.uint8), stable=True)  # free slot ids first
    target = torch.where(granted, free_list[torch.clamp_max(rank, n - 1)], n)

    # New-slot values: a clone copies its source; a split samples from the
    # Gaussian and shrinks it.
    dt = params.means.dtype
    if noise is None:
        noise = prng.normal(key, (n, 3), dev).to(dt)
    if noise2 is None:
        noise2 = prng.normal(prng.fold_in(key, 1), (n, 3), dev).to(dt)
    sample1 = params.means + _rot_apply(params.quats, noise * scales)
    sample2 = params.means + _rot_apply(params.quats, noise2 * scales)
    split_log_scales = params.log_scales - _log_f32(dcfg.split_scale_div)

    new_means = torch.where(split_m[:, None], sample1, params.means)
    new_log_scales = torch.where(split_m[:, None], split_log_scales, params.log_scales)

    # Scatter the new Gaussians into their granted slots (index n drops).
    means = _scatter(params.means, target, new_means)
    log_scales = _scatter(params.log_scales, target, new_log_scales)
    quats = _scatter(params.quats, target, params.quats)
    opacities = _scatter(params.opacities, target, params.opacities)
    sh = _scatter(params.sh, target, params.sh)
    ones = torch.ones_like(alive)
    grown = _scatter(alive, target, ones)

    # Split sources move to their second sample and shrink in place.
    src_split = split_m & granted
    means = torch.where(src_split[:, None], sample2, means)
    log_scales = torch.where(src_split[:, None], split_log_scales, log_scales)

    # Prune.
    prune = torch.sigmoid(opacities) < dcfg.min_opacity
    if dcfg.max_world_scale > 0:
        prune = prune | (torch.exp(log_scales).max(dim=-1).values
                         > dcfg.max_world_scale * scene_extent)
    if dcfg.max_screen_radius > 0:
        prune = prune | (state.max_radii > dcfg.max_screen_radius)
    alive_new = grown & ~prune

    new_params = GaussianParams(means=means, log_scales=log_scales, quats=quats,
                                opacities=opacities, sh=sh, alive=alive_new)

    # Fresh Adam moments for touched or dead slots.
    touched = _scatter(src_split | ~alive_new, target, ones)
    trace.count_round(dev, candidates=cand.sum(), granted=granted.sum(),
                      cloned=(granted & ~split_m).sum(), split=src_split.sum(),
                      pruned=(grown & prune).sum(), alive=alive_new.sum())
    return TrainState(
        params=new_params,
        mu=_zero_rows(state.mu, touched),
        nu=_zero_rows(state.nu, touched),
        count=state.count,
        step=state.step,
        grad_accum=torch.zeros_like(state.grad_accum),
        grad_count=torch.zeros_like(state.grad_count),
        max_radii=torch.zeros_like(state.max_radii),
    )


def _round(state: TrainState, key: torch.Tensor, dcfg: DensifyConfig,
           scene_extent: float) -> TrainState:
    # The round's stamp, then the module's densify_and_prune, looked up at
    # each call.
    refuse_surfels(state)
    trace.stage("densify", state.params.device)
    return densify_and_prune(state, key, dcfg, scene_extent)


def compile_densify():
    """:func:`densify_and_prune` as ``apps/train.py`` jits it
    (``jax.jit(densify_and_prune, static_argnames=("dcfg", "scene_extent"))``):
    captured once per config, extent and state shapes on the card and
    replayed, the key a tensor argument (``prng.key_tensor``), so each round
    with a new key replays. The state is not donated, as ``apps/train.py``
    donates none: the caller's state stays as it was, and the round's result
    is the caller's own copy."""
    return compile_step(_round, static_argnames=("dcfg", "scene_extent"))


@torch.no_grad()
def reset_opacity(state: TrainState, ceiling: float = 0.01) -> TrainState:
    """Clamp all opacities to at most ``ceiling`` (upstream 3DGS does this
    every 3000 steps to let pruning reconsider saturated Gaussians)."""
    raw_ceiling = _log_f32(ceiling / (1.0 - ceiling))
    params = dataclasses.replace(state.params,
                                 opacities=torch.clamp_max(state.params.opacities, raw_ceiling))
    return dataclasses.replace(state, params=params)
