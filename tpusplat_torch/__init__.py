"""tpusplat_torch — the PyTorch and CUDA port of tpusplat for NVIDIA Hopper.

A second package beside the JAX one, with its module layout and names.
Plain tensor code is PyTorch; the TPU kernels of the JAX package become
hand-written CUDA kernels for ``sm_90a`` (``csrc/``), built at first use.
A CPU tensor runs the plain PyTorch version of every kernel, a CUDA tensor
the kernel. Entry points take ``device`` (default ``"cuda"``).

    from tpusplat_torch import look_at_camera, random_scene, render, RenderConfig
    params = random_scene(100_000)
    cam = look_at_camera([0, 0.5, 9], [0, 0, 0], 1920, 1080, fov_deg=60)
    img = render(params, cam, RenderConfig())
"""

from tpusplat_torch.camera import look_at_camera, make_camera
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.io.ply import load_ply, save_ply
from tpusplat_torch.io.synthetic import random_scene
from tpusplat_torch.render import render, render_auto, render_profiled, render_stages
from tpusplat_torch.types import Camera, GaussianParams

load_scene = load_ply

__all__ = [
    "RenderConfig",
    "GaussianParams",
    "Camera",
    "make_camera",
    "look_at_camera",
    "load_ply",
    "load_scene",
    "save_ply",
    "random_scene",
    "render",
    "render_auto",
    "render_profiled",
    "render_stages",
]

__version__ = "0.1.0"
