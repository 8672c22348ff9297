"""Interactive rendering session (counterpart of ``tpusplat/session.py``), the
``VulkanSplatting`` facade analogue.

The reference's public API shape (``include/3dgs/3dgs.h:11-51``): a
configuration struct, an ``initialize()`` / repeated ``draw()`` embedding
contract, a self-driving ``start()`` loop, and the input-forwarding hooks
``log_translation`` (cursor deltas -> camera rotation) and ``log_movement``
(direction -> camera-frame translation), with the reference's motion
constants (``src/Renderer.cpp:33-83``: 0.005 rad/px around (0,-1,0) and
(-1,0,0), step 0.3 in the camera frame). The camera state is float64 numpy,
as in the JAX package; frames render on the session's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from tpusplat_torch import trace
from tpusplat_torch.camera import make_camera, quat_to_rotmat
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.io.ply import load_ply
from tpusplat_torch.render import compile_render, last_unit, render_auto, stage_times
from tpusplat_torch.types import GaussianParams, resolve_device

ROTATE_RAD_PER_PX = 0.005
MOVE_STEP = 0.3


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _axis_angle_quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2.0)
    return np.array([np.cos(angle / 2.0), *(axis * s)])


@dataclasses.dataclass
class SessionConfig:
    """RendererConfiguration analogue (include/3dgs/3dgs.h:13-25)."""

    scene: str = ""
    width: int = 1280
    height: int = 720
    fov: float = 45.0
    near: float = 0.2
    far: float = 1000.0
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)


class Session:
    """Holds camera state and renders frames on demand.

    Usage (externally driven, like the iOS shim):
        s = Session(SessionConfig(scene="garden.ply"))
        s.initialize()
        img, aux = s.draw()
        s.log_translation(dx, dy)   # cursor deltas
        s.log_movement(0, 0, -1)    # key direction (camera frame)

    or self-driving: ``s.start(frame_callback, max_frames=...)``. Frames
    render on ``device`` (the card unless the caller asks for the CPU);
    ``params``, when given, must already lie there.
    """

    def __init__(self, config: SessionConfig, params: GaussianParams | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if params is not None and params.device.type != self.device.type:
            raise ValueError(f"Session: params lie on {params.device}, the session renders "
                             f"on {self.device}")
        self.config = config
        self.params = params
        self.position = np.zeros(3)
        self.rotation = np.array([1.0, 0.0, 0.0, 0.0])  # (w,x,y,z)
        self._render = compile_render()  # the session's render graphs
        self._initialized = False

    # -- lifecycle (3dgs.h:27-41) --

    def initialize(self):
        if self.params is None:
            self.params = load_ply(self.config.scene, device=self.device)
        self._initialized = True

    def camera(self):
        """The camera of the current pose and resolution."""
        c = self.config
        return make_camera(self.position, self.rotation, c.width, c.height, fov_deg=c.fov,
                           near=c.near, far=c.far, device=self.device)

    @torch.no_grad()
    def draw(self):
        """Render one frame at the current camera; returns ([H,W,3], aux).

        On instance-capacity overflow the frame is rendered again with a
        grown capacity (``render_auto``, the reference's sort-buffer growth
        and retry, ``src/Renderer.cpp:541-563``); the grown config is kept
        for later frames. Frames replay the session's own render graph
        (``compile_render``), freed with the session. Host spans: ``draw``
        around ``camera`` and ``render_auto``.
        """
        assert self._initialized, "call initialize() first"
        with trace.span("draw"):
            with trace.span("camera"):
                cam = self.camera()
            img, aux, grown = render_auto(self.params, cam, self.config.render,
                                          compiled=self._render)
            if grown is not self.config.render:
                self.config = dataclasses.replace(self.config, render=grown)
        return img, aux

    @torch.no_grad()
    def draw_profiled(self):
        """draw(), returning (img, aux, stage_ms) with the frame's stage times.

        The per-stage metrics source for the viewer overlay (the reference
        shows live preprocess/sort/render ms from Vulkan timestamp queries,
        ``src/GUIManager.cpp:45-100``): the stamps of the frame's replay of
        the session's graph, regrow included (``preprocess``, ``bin+sort``,
        ``raster``; NaN when tracing is off). One synchronisation reads
        them."""
        img, aux = Session.draw(self)
        return img, aux, stage_times(last_unit(self.device, self._render.tag))

    def resize(self, width: int, height: int):
        """Change the render resolution mid-session.

        The analogue of the reference's swapchain recreation on resize
        (``src/Renderer.cpp:102-117``: recreate the swapchain, reallocate the
        tile-boundary buffer for the new grid, rebuild the pipeline). A new
        frame size is a new key of the session's compiled render, so the
        next ``draw()`` captures the render graph anew at the new size, as
        the reference rebuilds its pipeline (the two most recent sizes are
        kept).
        """
        self.config = dataclasses.replace(self.config, width=int(width), height=int(height))

    def start(self, on_frame: Callable | None = None, max_frames: int = 0,
              target_fps: float = 0.0):
        """Self-driving loop (Renderer::run analogue, src/Renderer.cpp:428-450)."""
        self.initialize()
        frames = 0
        t_last = time.time()
        while max_frames == 0 or frames < max_frames:
            img, aux = self.draw()
            frames += 1
            if on_frame is not None and on_frame(img, aux) is False:
                break
            if target_fps > 0:
                dt = time.time() - t_last
                if dt < 1.0 / target_fps:
                    time.sleep(1.0 / target_fps - dt)
                t_last = time.time()
        self.stop()

    def stop(self):
        self._initialized = False

    # -- input forwarding (3dgs.h:43-45; motion math src/Renderer.cpp:44-82) --

    def log_translation(self, dx: float, dy: float):
        """Cursor deltas -> camera rotation, 0.005 rad per pixel."""
        self.rotation = _quat_mul(
            self.rotation, _axis_angle_quat([0.0, -1.0, 0.0], dx * ROTATE_RAD_PER_PX))
        self.rotation = _quat_mul(
            self.rotation, _axis_angle_quat([-1.0, 0.0, 0.0], dy * ROTATE_RAD_PER_PX))
        self.rotation /= np.linalg.norm(self.rotation)

    def log_movement(self, x: float, y: float, z: float):
        """Move along a camera-frame direction, step 0.3 (normalized)."""
        d = np.array([x, y, z], np.float64)
        n = np.linalg.norm(d)
        if n == 0:
            return
        self.position = self.position + quat_to_rotmat(self.rotation) @ (d / n) * MOVE_STEP
