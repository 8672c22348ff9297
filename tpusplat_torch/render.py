"""The rendering pipeline facade (counterpart of ``tpusplat/render.py``):
preprocess -> bin and sort -> gather and blend, the analogue of the
reference's ``Renderer`` (``src/Renderer.cpp:366-426``).

Each stage routes by the device of its tensors (CPU: plain PyTorch; CUDA:
the hand-written kernels). :func:`render_stages` runs eagerly;
:func:`render_auto`, where the JAX package jits ``render_stages`` with
``cfg`` static, replays a :func:`compile_render`, a CUDA graph of it
captured once per configuration and frame size (:mod:`tpusplat_torch.compiled`),
which its caller owns.
``cfg.debug_checks`` adds the validation counters of
:mod:`tpusplat_torch.ops.validate` to ``aux["debug"]``. Each stage stamps
its start (:mod:`tpusplat_torch.trace`): ``preprocess``, ``binning``,
``blend``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from tpusplat_torch import trace
from tpusplat_torch.compiled import compile_step
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops import surfel, validate
from tpusplat_torch.ops.binning import bin_and_sort
from tpusplat_torch.ops.preprocess import preprocess
from tpusplat_torch.ops.rasterize import rasterize
from tpusplat_torch.types import Camera, GaussianParams, SurfelParams


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
    ``debug``, the validation counters (0-d int32 tensors).

    A surfel scene (``SurfelParams``) takes the surfel pipeline
    (:func:`tpusplat_torch.ops.surfel.render_stages2d`), whose aux adds its
    alpha, depth_sum, normal and distortion maps and has no ``debug``."""
    if isinstance(params, SurfelParams):
        return surfel.render_stages2d(params, camera, cfg)
    dev = params.device
    trace.stage("preprocess", dev)
    pg = preprocess(params, camera, cfg)
    trace.stage("binning", dev)
    binned = bin_and_sort(pg, camera.width, camera.height, cfg)
    trace.stage("blend", dev)
    img, aux = rasterize(pg, binned, camera.width, camera.height, cfg)
    return img, _finish_aux(aux, params, pg, binned, img, cfg)


def compile_render():
    """:func:`render_stages` as ``jax.jit(render_stages, static_argnames="cfg")``
    runs it: on the card a graph replay per frame, captured anew for a new
    cfg (a regrow), scene size or frame size; the two most recent keys are
    kept. The caller owns it, and with it the graphs' pools and static
    buffers (a copy of the scene's parameters): keep one across the frames
    of a viewer, a session or a trainer's evals, and let go of it with them."""
    return compile_step(render_stages, static_argnames=("cfg",))


PROFILED_STAGES = {"preprocess": "preprocess", "binning": "bin+sort", "blend": "raster"}
FRAME_STAMPS = len(PROFILED_STAGES) + 1  # a frame's stamps, its end included


def stage_times(unit) -> dict:
    """A frame's stage times in ms, from its stamps (a :class:`trace.Unit`,
    None when tracing is off), under the overlay's names: preprocess,
    bin+sort, raster (NaN without stamps)."""
    ms = unit.stage_ms() if unit is not None else {}
    return {shown: ms.get(name, math.nan) for name, shown in PROFILED_STAGES.items()}


def render_profiled(params: GaussianParams, camera: Camera, cfg: RenderConfig):
    """Render one frame eagerly, returning (img, aux, stage_ms).

    The stage times are read from the frame's own stamps (one
    synchronisation at the end), the analogue of the reference's timestamp
    queries (``src/Renderer.cpp:484-699``)."""
    with trace.tagged(trace.PROFILED):
        img, aux = render_stages(params, camera, cfg)
        trace.stage("end", params.device)
    return img, aux, stage_times(last_unit(params.device, trace.PROFILED))


def last_unit(device, tag: int):
    """The latest frame stamped with ``tag`` (None when tracing is off)."""
    if not trace.enabled:
        return None
    units = trace.read(device, last=FRAME_STAMPS + 1).units(tag)
    return units[-1] if units else None


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
    compiled=None,
):
    """Render with automatic instance-capacity recovery: on overflow, grow
    the capacity and render the frame again, so the frame returned is exact
    (the reference's sort-buffer regrow, ``src/Renderer.cpp:541-563``).

    Each render replays ``compiled``, the caller's :func:`compile_render`
    kept across frames. Without one, the call makes its own and frees it on
    return: every such call pays a capture (two warm-up renders, the
    captured one and a copy of the scene's parameters) and a free of the
    graph's pool, where a replay costs one frame, so a loop of frames
    holds one :func:`compile_render` across its calls. A grown capacity is
    a new cfg, so it captures anew, as a jitted render re-traces. The
    overflow counter is read on the host after each replay. The image and
    ``aux`` are the caller's own copies.

    Returns (img, aux, cfg): keep the returned cfg for later frames."""
    if cfg is None:
        cfg = RenderConfig()
    if compiled is None:
        compiled = compile_render()
    with trace.span("render_auto"):
        for _ in range(max_regrows + 1):
            img, aux = compiled(params, camera, cfg)
            with trace.span("read_overflow"):
                overflow = int(aux["capacity_overflow"])
            if overflow <= 0 or max_regrows <= 0:
                break
            with trace.span("regrow"):
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
