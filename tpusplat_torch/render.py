"""The rendering pipeline facade (counterpart of ``tpusplat/render.py``):
preprocess -> bin and sort -> gather and blend, the analogue of the
reference's ``Renderer`` (``src/Renderer.cpp:366-426``).

PyTorch runs eagerly, so there is no jit: each stage routes by the device
of its tensors (CPU: plain PyTorch; CUDA: the hand-written kernels).
``cfg.debug_checks`` adds the validation counters of
:mod:`tpusplat_torch.ops.validate` to ``aux["debug"]``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import torch

from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops import validate
from tpusplat_torch.ops.binning import bin_and_sort
from tpusplat_torch.ops.preprocess import preprocess
from tpusplat_torch.ops.rasterize import rasterize
from tpusplat_torch.types import Camera, GaussianParams


def _finish_aux(aux: dict, params: GaussianParams, pg, binned, img, cfg: RenderConfig):
    """The per-Gaussian statistics of densification and, with
    ``cfg.debug_checks``, the validation counters."""
    aux["visible"] = pg.ntiles > 0
    aux["radius"] = pg.radius
    if cfg.debug_checks:
        aux["debug"] = {**validate.check_processed(pg),
                        **validate.check_binned(binned, params.num_gaussians),
                        **validate.check_image(img)}
    return aux


def render_stages(params: GaussianParams, camera: Camera, cfg: RenderConfig):
    """Full pipeline, returning the image and diagnostic aux outputs:
    transmittance, capacity_overflow (nonzero means grow the capacity),
    tile_overflow (plain path only), gauss_overflow, num_instances,
    max_tile_count, visible and radius; with ``cfg.debug_checks`` also
    ``debug``, the validation counters (0-d int32 tensors)."""
    pg = preprocess(params, camera, cfg)
    binned = bin_and_sort(pg, camera.width, camera.height, cfg)
    img, aux = rasterize(pg, binned, camera.width, camera.height, cfg)
    return img, _finish_aux(aux, params, pg, binned, img, cfg)


def render_profiled(params: GaussianParams, camera: Camera, cfg: RenderConfig):
    """Render one frame stage by stage, returning (img, aux, stage_ms).

    On the card each stage is timed with CUDA events on the current stream
    (one synchronisation at the end of the frame); on the CPU with the host
    clock. The analogue of the reference's timestamp queries
    (``src/Renderer.cpp:484-699``)."""
    cuda = params.device.type == "cuda"
    marks = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    w, h = camera.width, camera.height
    mark()
    pg = preprocess(params, camera, cfg)
    mark()
    binned = bin_and_sort(pg, w, h, cfg)
    mark()
    img, aux = rasterize(pg, binned, w, h, cfg)
    mark()
    if cuda:
        marks[-1].synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    stage_ms = dict(zip(("preprocess", "bin+sort", "raster"), ms))
    return img, _finish_aux(aux, params, pg, binned, img, cfg), stage_ms


def render(params: GaussianParams, camera: Camera, cfg: RenderConfig | None = None):
    """Render one image [H, W, 3] float32 (the ``draw()`` analogue). With
    ``cfg.debug_checks``, raises ``RuntimeError`` on any violation."""
    img, aux = render_stages(params, camera, cfg or RenderConfig())
    validate.raise_on_violations(aux)
    return img


def render_auto(
    params: GaussianParams,
    camera: Camera,
    cfg: RenderConfig | None = None,
    max_regrows: int = 4,
    growth: float = 1.3,
):
    """Render with automatic instance-capacity recovery: on overflow, grow
    the capacity and render the frame again, so the frame returned is exact
    (the reference's sort-buffer regrow, ``src/Renderer.cpp:541-563``).

    Returns (img, aux, cfg): keep the returned cfg for later frames."""
    if cfg is None:
        cfg = RenderConfig()
    for _ in range(max_regrows + 1):
        img, aux = render_stages(params, camera, cfg)
        overflow = int(aux["capacity_overflow"])
        if overflow <= 0 or max_regrows <= 0:
            break
        needed = cfg.instance_capacity(params.num_gaussians) + overflow
        cfg = dataclasses.replace(cfg, capacity=int(needed * growth))
        max_regrows -= 1
    if overflow > 0:
        warnings.warn(
            f"render_auto: image truncated — {overflow} instances beyond "
            f"capacity {cfg.instance_capacity(params.num_gaussians)} after "
            "exhausting max_regrows",
            RuntimeWarning,
            stacklevel=2,
        )
    return img, aux, cfg


def render_batch(params: GaussianParams, cameras: list[Camera],
                 cfg: RenderConfig | None = None) -> torch.Tensor:
    """Render same-resolution cameras, one :func:`render_stages` each, into
    [B, H, W, 3] (the port has no stacked Camera: a batch is a list)."""
    cfg = cfg or RenderConfig()
    sizes = {(c.width, c.height) for c in cameras}
    if len(sizes) != 1:
        raise ValueError(f"render_batch: the cameras need one resolution, got {sorted(sizes)}")
    return torch.stack([render_stages(params, cam, cfg)[0] for cam in cameras])
