"""Core containers: Gaussian parameters and cameras (counterpart of
``tpusplat/types.py``).

As in the JAX package, parameters are kept *raw* (pre-activation) so they
stay trainable; activations are applied in :mod:`tpusplat_torch.ops`. The
containers are dataclasses of tensors; a tensor's device decides where the
pipeline runs (CPU: plain PyTorch; CUDA: the hand-written kernels).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for. Raises instead of falling
    back to the CPU when CUDA was asked for and is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


@dataclasses.dataclass
class GaussianParams:
    """Raw (pre-activation) Gaussian-splat parameters.

    Shapes (N = number of Gaussians), as in the JAX package:
      means:      [N, 3]     world-space positions
      log_scales: [N, 3]     log of per-axis scales (activation: exp)
      quats:      [N, 4]     (w, x, y, z), unnormalized (activation: normalize)
      opacities:  [N]        opacity logits (activation: sigmoid)
      sh:         [N, 16, 3] SH coefficients, interleaved RGB per coefficient
      alive:      [N] bool   dead slots render as fully transparent
    """

    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    sh: torch.Tensor
    alive: torch.Tensor

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @classmethod
    def create(
        cls, means, log_scales, quats, opacities, sh, alive=None,
        device="cuda", dtype=torch.float32,
    ) -> "GaussianParams":
        """From array-likes (numpy); ``sh`` may be [N, 16, 3] or [N, 48]."""
        dev = resolve_device(device)

        def t(x):
            return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

        means = t(means)
        n = means.shape[0]
        if alive is None:
            alive = np.ones((n,), bool)
        return cls(
            means=means,
            log_scales=t(log_scales),
            quats=t(quats),
            opacities=t(opacities).reshape(n),
            sh=t(sh).reshape(n, 16, 3),  # [N, 48] flat interleaved -> [N, 16, 3]
            alive=torch.tensor(np.asarray(alive, bool), device=dev),
        )


@dataclasses.dataclass
class SurfelParams:
    """Raw parameters of 2D Gaussian surfels (2D Gaussian Splatting, Huang
    et al. 2024): oriented planar disks. The fields are
    :class:`GaussianParams`' but ``log_scales``, which holds the two
    tangent axes' scales:
      means:      [N, 3]     disk centres
      log_scales: [N, 2]     log of the scales along the tangent axes
                             t_u, t_v (columns 0 and 1 of R(quats))
      quats:      [N, 4]     (w, x, y, z); column 2 of R is the disk's axis
      opacities:  [N]        opacity logits
      sh:         [N, 16, 3] SH coefficients
      alive:      [N] bool
    The scene's type routes every entry point (``render_stages``,
    ``train_step``) to the surfel pipeline (:mod:`tpusplat_torch.ops.surfel`).
    """

    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    sh: torch.Tensor
    alive: torch.Tensor

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @classmethod
    def from_gaussians(cls, params: GaussianParams) -> "SurfelParams":
        """The surfels of a Gaussian scene: its first two scales become the
        disks' (a random scene's draws serve either primitive)."""
        return cls(means=params.means, log_scales=params.log_scales[:, :2].contiguous(),
                   quats=params.quats, opacities=params.opacities, sh=params.sh,
                   alive=params.alive)


@dataclasses.dataclass
class Camera:
    """A camera in the reference's shader convention (see
    :mod:`tpusplat_torch.camera`). ``view``/``proj`` are [4, 4] float32,
    ``cam_pos`` [3], ``tan_fovx``/``tan_fovy`` 0-d float32 tensors, and
    ``width``/``height`` Python ints (they fix the output shapes)."""

    view: torch.Tensor
    proj: torch.Tensor
    cam_pos: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor
    width: int
    height: int

    @classmethod
    def from_matrices(
        cls, view, proj, cam_pos, tan_fovx, tan_fovy, width: int, height: int,
        device="cuda",
    ) -> "Camera":
        dev = resolve_device(device)

        def t(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        return cls(
            view=t(view),
            proj=t(proj),
            cam_pos=t(cam_pos),
            tan_fovx=t(tan_fovx),
            tan_fovy=t(tan_fovy),
            width=int(width),
            height=int(height),
        )
