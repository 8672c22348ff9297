"""The independent differentiable oracle (counterpart of ``golden_render_jnp``
in ``tpusplat/ops/golden.py``), for the GPU gate
(:mod:`tpusplat_torch.bench.gpu_gate`) and the tests.

A naive O(N * pixels) blend in plain PyTorch ops: per pixel, every Gaussian
whose tile box covers the pixel's tile, in one global depth order, through
[N, P] masks and a ``cumprod`` down the depth axis. It keeps the discrete
structure of the tile pipeline (tile boxes, the alpha and transmittance
tests) and none of its machinery: no instance emission, no per-tile sort,
no chunks, no kernel. Small scenes only: it holds about ten [N, P] tensors
and their autograd residuals.
"""

from __future__ import annotations

import torch

from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops.preprocess import preprocess
from tpusplat_torch.types import Camera, GaussianParams


def golden_render(params: GaussianParams, camera: Camera, cfg: RenderConfig) -> torch.Tensor:
    """[H, W, 3] image, differentiable with respect to ``params``."""
    pg = preprocess(params, camera, cfg)
    w_img, h_img = camera.width, camera.height
    dev = pg.uv.device

    visible = pg.ntiles > 0
    key = torch.where(visible, pg.depth.detach(), float("inf"))
    order = torch.argsort(key, stable=True)  # carries no gradient
    uv, conic, opacity = pg.uv[order], pg.conic[order], pg.opacity[order]
    color, aabb, live = pg.color[order], pg.aabb[order], visible[order]

    py, px = torch.meshgrid(torch.arange(h_img, device=dev), torch.arange(w_img, device=dev),
                            indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    tx, ty = px // cfg.tile_w, py // cfg.tile_h

    # [N, P] masks and alphas
    covers = (
        live[:, None]
        & (aabb[:, 0:1] <= tx[None, :])
        & (tx[None, :] < aabb[:, 2:3])
        & (aabb[:, 1:2] <= ty[None, :])
        & (ty[None, :] < aabb[:, 3:4])
    )
    dx = uv[:, 0:1] - px.to(uv.dtype)[None, :]
    dy = uv[:, 1:2] - py.to(uv.dtype)[None, :]
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(opacity[:, None] * torch.exp(power), cfg.alpha_max)
    ok = covers & (power <= 0.0) & (alpha >= cfg.alpha_min)
    f = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
    t_incl = torch.cumprod(f, dim=0)
    t_excl = t_incl / f
    contrib = ok & (t_incl >= cfg.t_min)
    wgt = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))  # [N, P]
    rgb = wgt.T @ color
    return rgb.reshape(h_img, w_img, 3)
