"""Adaptive density control: clone / split / prune under a static capacity
(counterpart of ``tpusplat/train/densify.py``).

The Gaussian count never changes: the parameter tensors have a fixed
capacity N and an ``alive`` mask; dead slots render as fully transparent.
Densification grants free slots to the candidates with the largest average
positional gradient, pruning frees them, and the Adam moments of every
touched slot are zeroed. Shapes stay fixed and nothing is read on the host.

Recipe (upstream 3DGS semantics, as in the JAX package):
  * candidates: average positional-gradient norm >= grad_threshold, alive;
  * clone (scale small): copy the Gaussian into a free slot;
  * split (scale large): two samples from the Gaussian, scale / 1.6 -- one
    replaces the source slot, one takes a free slot;
  * prune: opacity below min_opacity (plus the optional size caps).

The split noise comes from a ``torch.Generator``; ``noise``/``noise2``
may be passed instead (the tests hand in the JAX package's draws).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpusplat_torch.ops.activations import normalize_quat
from tpusplat_torch.train.step import TrainState
from tpusplat_torch.types import GaussianParams


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


def _scatter(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """A copy of ``dst`` with rows ``idx`` set to ``src`` (unique indices)."""
    out = dst.clone()
    out[idx] = src
    return out


@torch.no_grad()
def densify_and_prune(
    state: TrainState,
    generator: torch.Generator | None,
    dcfg: DensifyConfig,
    scene_extent: float,
    noise: torch.Tensor | None = None,
    noise2: torch.Tensor | None = None,
) -> TrainState:
    """One densification round. ``noise``/``noise2`` ([N, 3]) are the two
    standard-normal split draws; drawn from ``generator`` when not given."""
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

    # The j-th granted candidate (by rank) gets the j-th free slot (ascending).
    free_list = torch.argsort((~free).to(torch.uint8), stable=True)  # free slot ids first
    target = free_list[torch.clamp_max(rank, n - 1)]

    # New-slot values: a clone copies its source; a split samples from the
    # Gaussian and shrinks it.
    dt = params.means.dtype
    if noise is None:
        noise = torch.randn((n, 3), generator=generator, dtype=dt, device=dev)
    if noise2 is None:
        noise2 = torch.randn((n, 3), generator=generator, dtype=dt, device=dev)
    sample1 = params.means + _rot_apply(params.quats, noise * scales)
    sample2 = params.means + _rot_apply(params.quats, noise2 * scales)
    split_log_scales = params.log_scales - torch.log(
        torch.tensor(dcfg.split_scale_div, dtype=dt, device=dev))

    new_means = torch.where(split_m[:, None], sample1, params.means)
    new_log_scales = torch.where(split_m[:, None], split_log_scales, params.log_scales)

    # Scatter the new Gaussians into their granted slots.
    dst = target[granted]
    means = _scatter(params.means, dst, new_means[granted])
    log_scales = _scatter(params.log_scales, dst, new_log_scales[granted])
    quats = _scatter(params.quats, dst, params.quats[granted])
    opacities = _scatter(params.opacities, dst, params.opacities[granted])
    sh = _scatter(params.sh, dst, params.sh[granted])
    alive_new = _scatter(alive, dst, torch.ones_like(dst, dtype=torch.bool))

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
    alive_new = alive_new & ~prune

    new_params = GaussianParams(means=means, log_scales=log_scales, quats=quats,
                                opacities=opacities, sh=sh, alive=alive_new)

    # Fresh Adam moments for touched or dead slots.
    touched = _scatter(src_split | ~alive_new, dst, torch.ones_like(dst, dtype=torch.bool))
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


@torch.no_grad()
def reset_opacity(state: TrainState, ceiling: float = 0.01) -> TrainState:
    """Clamp all opacities to at most ``ceiling`` (upstream 3DGS does this
    every 3000 steps to let pruning reconsider saturated Gaussians)."""
    op = state.params.opacities
    raw_ceiling = torch.log(torch.tensor(ceiling / (1.0 - ceiling), dtype=op.dtype,
                                         device=op.device))
    params = dataclasses.replace(state.params, opacities=torch.minimum(op, raw_ceiling))
    return dataclasses.replace(state, params=params)
