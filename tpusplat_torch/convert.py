"""The weight carrier: state of the JAX package, given as numpy arrays
(``tpusplat.types.to_numpy(...)``), turned into the port's containers on
a chosen device. The port never imports the JAX package; callers hand
over plain arrays and dicts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops.preprocess import ProcessedGaussians
from tpusplat_torch.types import Camera, GaussianParams, resolve_device


def params_from_numpy(means, log_scales, quats, opacities, sh, alive=None,
                      device="cuda") -> GaussianParams:
    """GaussianParams from raw arrays (float32; ``sh`` [N, 16, 3] or [N, 48])."""
    return GaussianParams.create(means, log_scales, quats, opacities, sh, alive,
                                 device=device)


def camera_from_numpy(view, proj, cam_pos, tan_fovx, tan_fovy, width: int, height: int,
                      device="cuda") -> Camera:
    """A Camera from its matrices and scalars, as the JAX Camera holds them."""
    return Camera.from_matrices(view, proj, cam_pos, tan_fovx, tan_fovy, width, height,
                                device=device)


def processed_from_numpy(uv, conic, opacity, color, depth, aabb, ntiles, radius,
                         device="cuda") -> ProcessedGaussians:
    """ProcessedGaussians from the JAX package's fields (float32; aabb and
    ntiles int32)."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.tensor(np.asarray(x, dtype), device=dev)

    f, i = np.float32, np.int32
    return ProcessedGaussians(
        uv=t(uv, f), conic=t(conic, f), opacity=t(opacity, f), color=t(color, f),
        depth=t(depth, f), aabb=t(aabb, i), ntiles=t(ntiles, i), radius=t(radius, f))


def train_state_from_numpy(params: dict, mu: dict, nu: dict, count: dict, step,
                          grad_accum, grad_count, max_radii, device="cuda"):
    """The port's TrainState from the JAX package's, given as numpy:
    ``params`` the GaussianParams fields (``alive`` included); ``mu``,
    ``nu`` and ``count`` per parameter group, Adam's moments and update
    count as the group's ``ScaleByAdamState`` holds them under
    ``opt_state.inner_states[group].inner_state[0]``; ``step`` and the
    densification statistics."""
    from tpusplat_torch.train.step import TRAINABLE, TrainState

    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=dev)

    return TrainState(
        params=params_from_numpy(**params, device=dev),
        mu={k: f32(mu[k]) for k in TRAINABLE}, nu={k: f32(nu[k]) for k in TRAINABLE},
        count={k: i32(count[k]) for k in TRAINABLE}, step=i32(step),
        grad_accum=f32(grad_accum), grad_count=f32(grad_count), max_radii=f32(max_radii))


def config_from_fields(fields: dict) -> RenderConfig:
    """A RenderConfig from the JAX RenderConfig's fields
    (``dataclasses.asdict``). ``use_pallas`` is dropped: the port routes by
    tensor device instead."""
    names = {f.name for f in dataclasses.fields(RenderConfig)}
    unknown = set(fields) - names - {"use_pallas"}
    if unknown:
        raise ValueError(f"config_from_fields: unknown fields {sorted(unknown)}")
    return RenderConfig(**{k: v for k, v in fields.items() if k in names})
