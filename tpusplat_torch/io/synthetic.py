"""Synthetic random scenes (counterpart of ``tpusplat/io/synthetic.py``).

The numpy draws are the JAX package's, in the same order, so one seed gives
the same arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from tpusplat_torch.types import GaussianParams


def random_scene(
    n: int,
    seed: int = 0,
    extent: float = 3.0,
    sh_degree: int = 3,
    scale_range: tuple[float, float] = (0.01, 0.15),
    opacity_range: tuple[float, float] = (0.1, 0.95),
    device="cuda",
) -> GaussianParams:
    """Random Gaussians uniform in a cube of half-side ``extent``; raw
    parameters come from inverse activations (log scales, logit opacity)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    scales = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    log_scales = np.log(scales)
    quats = rng.normal(0.0, 1.0, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    op = rng.uniform(*opacity_range, n).astype(np.float32)
    opacities = np.log(op / (1.0 - op))  # logit
    sh = np.zeros((n, 16, 3), np.float32)
    ncoeff = (sh_degree + 1) ** 2
    sh[:, 0, :] = rng.uniform(-1.0, 1.5, (n, 3))
    if ncoeff > 1:
        sh[:, 1:ncoeff, :] = rng.uniform(-0.3, 0.3, (n, ncoeff - 1, 3))
    return GaussianParams.create(means=means, log_scales=log_scales, quats=quats,
                                 opacities=opacities, sh=sh, device=device)
