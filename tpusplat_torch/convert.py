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


def config_from_fields(fields: dict) -> RenderConfig:
    """A RenderConfig from the JAX RenderConfig's fields
    (``dataclasses.asdict``). ``use_pallas`` is dropped: the port routes by
    tensor device instead."""
    names = {f.name for f in dataclasses.fields(RenderConfig)}
    unknown = set(fields) - names - {"use_pallas"}
    if unknown:
        raise ValueError(f"config_from_fields: unknown fields {sorted(unknown)}")
    return RenderConfig(**{k: v for k, v in fields.items() if k in names})
