"""Training losses: L1 + D-SSIM, the original 3DGS objective (counterpart of
``tpusplat/train/losses.py``).

Images keep the JAX package's layout at the public functions: [H, W, C] or
[B, H, W, C]. The depthwise 11x11 Gaussian filter of SSIM is
``torch.nn.functional.conv2d`` with ``groups=C`` and zero padding
``size // 2``, the SAME padding of the JAX ``conv_general_dilated`` for an
odd window. It is not a TPU kernel of the JAX package (XLA's convolution),
so a library convolution is its port. Parity precision needs it in fp32:
callers on the card set ``torch.backends.cudnn.allow_tf32 = False``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(img - target))


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim_map(img: torch.Tensor, target: torch.Tensor, size: int = 11,
             sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM map [B, H, W, C] for [B, H, W, C] pairs (SAME zero
    padding; C1 = 0.01^2, C2 = 0.03^2 for [0, 1] images; 11x11 Gaussian
    window, the original 3DGS settings)."""
    c = img.shape[-1]
    weight = _gaussian_window(size, sigma, img.device).expand(c, 1, size, size).contiguous()

    def filt(x):  # NHWC in, NHWC out; depthwise
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=size // 2, groups=c)
        return y.permute(0, 2, 3, 1)

    mu_x = filt(img)
    mu_y = filt(target)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = filt(img * img) - mu_x2
    sigma_y = filt(target * target) - mu_y2
    sigma_xy = filt(img * target) - mu_xy

    c1, c2 = 0.01**2, 0.03**2
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2)
    return num / den


def ssim(img: torch.Tensor, target: torch.Tensor, size: int = 11, sigma: float = 1.5,
         crop_border: bool = False) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] (or [B, H, W, C]) image pair.

    ``crop_border`` drops the size//2-wide frame where SAME zero padding
    biases the local statistics: the eval metric crops, the training loss
    keeps the full map, as in the JAX package."""
    if img.dim() == 3:
        img = img[None]
        target = target[None]
    smap = ssim_map(img, target, size, sigma)
    if crop_border:
        hb = size // 2
        smap = smap[:, hb:-hb, hb:-hb]
    return torch.mean(smap)


def psnr(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB for [0, 1]-range images."""
    mse = torch.mean((img - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-10))


def gs_loss(img: torch.Tensor, target: torch.Tensor, ssim_weight: float = 0.2) -> torch.Tensor:
    """(1 - w) * L1 + w * (1 - SSIM), the 3DGS photometric objective."""
    return (1.0 - ssim_weight) * l1_loss(img, target) + ssim_weight * (
        1.0 - ssim(img, target)
    )


# -- 2D Gaussian Splatting's regularizers (Huang et al. 2024, arXiv:2403.17888) --

# The weights of a surfel scene's two regularizers beside the photometric
# loss: the depth distortion's and the normal consistency's, the paper's for
# unbounded scenes, both active as after its densification.
LAMBDA_DIST = 100.0
LAMBDA_NORMAL = 0.05


def depth_normals(alpha: torch.Tensor, depth_sum: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """[H, W, 3] unit normals of the expected depth ``depth_sum / alpha`` (0
    where ``alpha`` is 0), unprojected to camera-space points ``P`` with the
    intrinsics: ``normalize((P[y+1] - P[y-1]) x (P[x+1] - P[x-1]))`` on the
    interior pixels, 0 on the border. The order of the cross product orients
    them as the surfels' normals face the camera: a fronto-parallel disk
    gives its own normal."""
    h, w = alpha.shape
    dev, dt = alpha.device, alpha.dtype
    pos = alpha > 0
    z = torch.where(pos, depth_sum / torch.where(pos, alpha, torch.ones_like(alpha)),
                    torch.zeros_like(alpha))
    xs = (torch.arange(w, device=dev, dtype=dt) - cx) / fx
    ys = (torch.arange(h, device=dev, dtype=dt) - cy) / fy
    pts = torch.stack([z * xs[None, :], z * ys[:, None], z], dim=-1)
    dx = pts[1:-1, 2:] - pts[1:-1, :-2]
    dy = pts[2:, 1:-1] - pts[:-2, 1:-1]
    n = F.normalize(torch.linalg.cross(dy, dx, dim=-1), dim=-1)
    return F.pad(n, (0, 0, 1, 1, 1, 1))


def surfel_regularizers(maps: dict, fx, fy, cx, cy):
    """(mean depth distortion, mean normal consistency) of a surfel frame's
    maps (``ops.surfel.split_maps``): ``L_n = A - N . N~``, which is
    ``sum_i w_i (1 - n_i . N~)``, with ``N~`` the normals of the expected
    depth (:func:`depth_normals`)."""
    n_depth = depth_normals(maps["alpha"], maps["depth_sum"], fx, fy, cx, cy)
    l_n = maps["alpha"] - (maps["normal"] * n_depth).sum(-1)
    return maps["distortion"].mean(), l_n.mean()
