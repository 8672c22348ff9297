"""The plain reference of 2D Gaussian Splatting (Huang, Yu, Chen, Geiger and
Gao, "2D Gaussian Splatting for Geometrically Accurate Radiance Fields",
SIGGRAPH 2024, arXiv:2403.17888; github.com/hbb1/2d-gaussian-splatting),
as the port renders and trains it: the surfels' projection, the ray-splat
blend with its colour, alpha, depth, normal and distortion maps, the loss
with the two regularizers, and the gradients by autograd.

It imports torch alone: no kernel and no module of the port, nor JAX. It
has no tiles, caches or capacity: every surfel is tested against every
pixel, front to back in the order of the centres' depth (ties by index),
so it suits the small sizes of the CPU tests. It computes in the dtype of
the parameters it is given, with TF32 off (:func:`full_fp32`).

Departures from the paper, as the port makes them (the benchmark's
configuration lists them under ``assumed``):

* the distortion is ``sum_i w_i sum_{j<i} w_j (m_i - m_j)^2`` with
  ``m = far / (far - near) (1 - near / z)``, near 0.2 and far 100, taken
  in one front-to-back pass from running sums (:func:`render`); the
  literal double sum (``distortion="double_sum"``) is the check on it;
* a pair's depth is its ray's intersection with the disk's plane where
  the disk's own Gaussian wins (``u^2 + v^2 <= 2 |x - c|^2``), and the
  centre's depth where the low-pass filter wins (the disk seen nearly
  edge-on, the intersection far outside it); the paper's code takes the
  centre's depth in that branch's gradient;
* where a pixel's ray ``r = ((x - c_x) / f_x, (y - c_y) / f_y, 1)`` grazes
  the disk's plane, ``|n . r| < 0.01 |r|`` (within about half a degree of
  edge-on), the disk's term is left out and the filter's holds: there the
  disk's term and its gradients are rounding noise;
* the depth is the expected depth ``D / A``, not the median;
* a surfel is culled where its centre lies at depth <= 0.2, where its
  3-sigma disk or its disk out to ``sqrt(2 ln(op / alpha_min))`` sigmas
  reaches the camera's plane, or where its opacity is under alpha_min;
* pixel centres at integer coordinates, intrinsics from the port's
  cameras (the shader frame: x right, y down, z forward).

A camera is a dict: ``view`` [4, 4] (rows 0-2 are [R_cw | t_cw]),
``cam_pos`` [3], ``tan_fovx``, ``tan_fovy``, ``width``, ``height``.
Parameters are a dict of ``means`` [N, 3], ``log_scales`` [N, 2],
``quats`` [N, 4], ``opacities`` [N], ``sh`` [N, 16, 3], ``alive`` [N].
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
NEAR, FAR = 0.2, 100.0
GRAZING = 1e-2
ALPHA_MAX, ALPHA_MIN, T_MIN = 0.99, 1.0 / 255.0, 1e-4
FIELDS = ("means", "log_scales", "quats", "opacities", "sh")


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmuls and cuDNN, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """The real SH basis of degree 3 at unit directions d [N, 3]: [N, 16]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * z * x,
        SH_C2[4] * (xx - yy),
        SH_C3[0] * (3 * xx - yy) * y, SH_C3[1] * x * y * z, SH_C3[2] * (4 * zz - xx - yy) * y,
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
        SH_C3[5] * (xx - yy) * z, SH_C3[6] * x * (xx - 3 * yy)], dim=1)


def rotation(q: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] rotation matrices of (w, x, y, z) quaternions."""
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True))
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def intrinsics(cam: dict):
    """(f_x, f_y, c_x, c_y): pixel centres at integer coordinates."""
    fx = cam["width"] / (2.0 * cam["tan_fovx"])
    fy = cam["height"] / (2.0 * cam["tan_fovy"])
    return fx, fy, (cam["width"] - 1) / 2.0, (cam["height"] - 1) / 2.0


def _dual_conic(t: torch.Tensor, k2):
    """(centre [N, 2], half-extents [N, 2], C*_33 [N]) of the disk
    ``u^2 + v^2 <= k2`` under T [N, 3, 3], from ``T diag(k2, k2, -1) T^T``."""
    dt = torch.ones_like(t[:, 0, :])
    diag = torch.stack([k2 * dt[:, 0], k2 * dt[:, 1], -dt[:, 2]], -1)  # [N, 3]
    cs = torch.einsum("nik,nk,njk->nij", t, diag, t)
    c33 = cs[:, 2, 2]
    safe = torch.where(c33 < 0, c33, -torch.ones_like(c33))
    centre = torch.stack([cs[:, 0, 2], cs[:, 1, 2]], -1) / safe[:, None]
    diag2 = torch.stack([cs[:, 0, 0], cs[:, 1, 1]], -1) / safe[:, None]
    half = torch.sqrt(torch.clamp_min(centre * centre - diag2, 1e-4))
    return centre, half, c33


def project(p: dict, cam: dict, sh_degree: int = 3) -> dict:
    """Each surfel's T [N, 3, 3] (rows T_u, T_v, T_w), filter centre
    ``c`` [N, 2], opacity [N], colour [N, 3], normal [N, 3] (camera
    frame, facing the camera), centre depth [N] and ``visible`` [N]."""
    view = p["means"].new_tensor(cam["view"]) if not torch.is_tensor(cam["view"]) \
        else cam["view"].to(p["means"].dtype)
    r_cw, t_cw = view[:3, :3], view[:3, 3]
    rot = rotation(p["quats"])
    s = torch.exp(p["log_scales"])
    p_cam = p["means"] @ r_cw.T + t_cw
    axes = torch.einsum("ij,njk->nik", r_cw, rot)  # the axes in the camera frame
    fx, fy, cx, cy = intrinsics(cam)
    k = view.new_tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    cols = torch.stack([axes[:, :, 0] * s[:, :1], axes[:, :, 1] * s[:, 1:2], p_cam], -1)
    t = torch.einsum("ij,njk->nik", k, cols)
    n = axes[:, :, 2]
    facing = (n * p_cam).sum(-1)
    n = n * torch.where(facing > 0, -1.0, 1.0).to(n.dtype)[:, None].detach()
    centre, _, c33 = _dual_conic(t, 9.0)
    opacity = torch.sigmoid(p["opacities"])
    with torch.no_grad():
        k2 = torch.clamp_min(2.0 * torch.log(torch.clamp_min(opacity, 1e-30) / ALPHA_MIN), 9.0)
        _, _, c33_box = _dual_conic(t.detach(), k2)
        visible = (p["alive"] & (p_cam[:, 2] > NEAR) & (c33 < 0) & (c33_box < 0)
                   & (opacity >= ALPHA_MIN))
    cam_pos = p["means"].new_tensor(cam["cam_pos"]) if not torch.is_tensor(cam["cam_pos"]) \
        else cam["cam_pos"].to(p["means"].dtype)
    d = p["means"] - cam_pos
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    kk = (sh_degree + 1) ** 2
    rgb = torch.einsum("nk,nkc->nc", sh_basis(d)[:, :kk], p["sh"][:, :kk]) + 0.5
    rgb = torch.cat([rgb[:, :1].clamp_min(0.0), rgb[:, 1:]], dim=1)
    return dict(t=t, c=centre, opacity=opacity, rgb=rgb, normal=n, depth=p_cam[:, 2].detach(),
                visible=visible)


def render(pr: dict, cam: dict, distortion: str = "one_pass", pixels: int = 4096) -> dict:
    """The maps of every pixel: ``rgb`` [H, W, 3], ``alpha``, ``depth_sum``,
    ``normal`` [H, W, 3], ``distortion`` and the final transmittance
    ``tmap`` [H, W], ``pixels`` pixels at a time. ``distortion`` is
    ``"one_pass"`` (the running sums) or ``"double_sum"`` (the literal sum
    over pairs, for small sizes)."""
    vis = torch.nonzero(pr["visible"]).squeeze(1)
    vis = vis[torch.sort(pr["depth"][vis], stable=True).indices]
    t = pr["t"][vis]  # [K, 3, 3] in depth order
    c, op, rgb, nrm = pr["c"][vis], pr["opacity"][vis], pr["rgb"][vis], pr["normal"][vis]
    w_img, h_img = cam["width"], cam["height"]
    dt, dev = t.dtype, t.device
    ys, xs = torch.meshgrid(torch.arange(h_img, device=dev, dtype=dt),
                            torch.arange(w_img, device=dev, dtype=dt), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    out = []
    for a in range(0, xs.shape[0], pixels):
        out.append(_blend(t, c, op, rgb, nrm, xs[a:a + pixels, None], ys[a:a + pixels, None],
                          cam, distortion))
    maps = torch.cat(out).reshape(h_img, w_img, -1)
    return dict(rgb=maps[..., 0:3], alpha=maps[..., 3], depth_sum=maps[..., 4],
                normal=maps[..., 5:8], distortion=maps[..., 8], tmap=maps[..., 9])


def _blend(t, c, op, rgb, nrm, x, y, cam, distortion):
    """Pixels x, y [P, 1] against the K surfels in order: [P, 10]."""
    fx, fy, cx, cy = intrinsics(cam)
    rx, ry = (x - cx) / fx, (y - cy) / fy
    ray_n = torch.sqrt(rx * rx + ry * ry + 1.0)
    grazing = (nrm[None, :, 0] * rx + nrm[None, :, 1] * ry + nrm[None, :, 2]).abs() \
        < GRAZING * ray_n
    kv = x[..., None] * t[None, :, 2, :] - t[None, :, 0, :]  # [P, K, 3]
    lv = y[..., None] * t[None, :, 2, :] - t[None, :, 1, :]
    h = torch.linalg.cross(kv, lv, dim=-1)
    ok_h = h[..., 2] != 0
    hz = torch.where(ok_h, h[..., 2], torch.ones_like(h[..., 2]))
    u, v = h[..., 0] / hz, h[..., 1] / hz
    rho3 = torch.where(grazing, torch.full_like(u, float("inf")), u * u + v * v)
    rho2 = 2.0 * ((c[None, :, 0] - x) ** 2 + (c[None, :, 1] - y) ** 2)
    use3 = rho3 <= rho2
    rho = torch.where(use3, rho3, rho2)
    z = torch.where(use3, t[None, :, 2, 0] * u + t[None, :, 2, 1] * v + t[None, :, 2, 2],
                    t[None, :, 2, 2].expand_as(u))
    alpha = torch.clamp_max(op[None, :] * torch.exp(-0.5 * rho), ALPHA_MAX)
    ok = ok_h & (z >= NEAR) & (alpha >= ALPHA_MIN)
    f = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
    t_incl = torch.cumprod(f, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    contrib = ok & (t_incl >= T_MIN)
    w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
    zs = torch.where(contrib, z, torch.ones_like(z))
    m = (FAR / (FAR - NEAR)) * (1.0 - NEAR / zs)
    if distortion == "double_sum":
        diff = m[:, :, None] - m[:, None, :]  # [P, i, j]
        lower = torch.tril(torch.ones(m.shape[1], m.shape[1], dtype=torch.bool,
                                      device=m.device), diagonal=-1)
        dist = (w[:, :, None] * w[:, None, :] * diff * diff * lower).sum((1, 2))
    else:
        def before(x):
            s = torch.cumsum(x, dim=1)
            return torch.cat([torch.zeros_like(s[:, :1]), s[:, :-1]], dim=1)

        dist = (w * (m * m * before(w) - 2.0 * m * before(w * m) + before(w * m * m))).sum(1)
    return torch.cat([w @ rgb, w.sum(1, keepdim=True), (w * z).sum(1, keepdim=True), w @ nrm,
                      dist[:, None], t_incl[:, -1:]], dim=1)


def depth_normals(alpha, depth_sum, cam: dict) -> torch.Tensor:
    """[H, W, 3] normals of the expected depth (0 where alpha is 0):
    ``normalize((P[y+1] - P[y-1]) x (P[x+1] - P[x-1]))`` of the unprojected
    points on interior pixels, 0 on the border; a fronto-parallel disk gives
    its own (camera-facing) normal."""
    fx, fy, cx, cy = intrinsics(cam)
    h, w = alpha.shape
    z = torch.where(alpha > 0, depth_sum / torch.where(alpha > 0, alpha, 1.0), 0.0)
    xs = (torch.arange(w, dtype=alpha.dtype, device=alpha.device) - cx) / fx
    ys = (torch.arange(h, dtype=alpha.dtype, device=alpha.device) - cy) / fy
    pts = torch.stack([z * xs[None, :], z * ys[:, None], z], -1)
    n = torch.zeros_like(pts)
    cross = torch.linalg.cross(pts[2:, 1:-1] - pts[:-2, 1:-1], pts[1:-1, 2:] - pts[1:-1, :-2],
                               dim=-1)
    n[1:-1, 1:-1] = cross / torch.clamp_min(torch.linalg.vector_norm(cross, dim=-1,
                                                                     keepdim=True), 1e-12)
    return n


def ssim_mean(img, target, size=11, sigma=1.5):
    """Mean SSIM of an [H, W, C] pair (11-tap Gaussian window, zero padding)."""
    c = img.shape[-1]
    x = torch.arange(size, dtype=torch.float64) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    g = (g / g.sum()).to(img.dtype).to(img.device)
    win = (g[:, None] * g[None, :]).expand(c, 1, size, size).contiguous()

    def filt(v):
        return F.conv2d(v.permute(2, 0, 1)[None], win, padding=size // 2, groups=c)

    mx, my = filt(img), filt(target)
    sxx, syy, sxy = filt(img * img) - mx * mx, filt(target * target) - my * my, \
        filt(img * target) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mx * my + c1) * (2 * sxy + c2))
            / ((mx * mx + my * my + c1) * (sxx + syy + c2))).mean()


def loss(maps: dict, target, cam: dict, ssim_weight=0.2, lambda_dist=100.0,
         lambda_normal=0.05):
    """``(1 - w) L1 + w (1 - SSIM) + lambda_dist mean(L_d) + lambda_normal
    mean(L_n)``, ``L_n = A - N . N~``."""
    img = maps["rgb"]
    photo = (1 - ssim_weight) * (img - target).abs().mean() + ssim_weight * (
        1 - ssim_mean(img, target))
    n_depth = depth_normals(maps["alpha"], maps["depth_sum"], cam)
    l_n = maps["alpha"] - (maps["normal"] * n_depth).sum(-1)
    return photo + lambda_dist * maps["distortion"].mean() + lambda_normal * l_n.mean()


def loss_and_grads(p: dict, cam: dict, target, ssim_weight=0.2, lambda_dist=100.0,
                   lambda_normal=0.05, sh_degree=3):
    """(loss, {leaf: gradient}) of one view, by autograd."""
    leaves = {k: p[k].detach().requires_grad_(True) for k in FIELDS}
    with torch.enable_grad():
        maps = render(project(dict(leaves, alive=p["alive"]), cam, sh_degree), cam)
        value = loss(maps, target, cam, ssim_weight, lambda_dist, lambda_normal)
        grads = torch.autograd.grad(value, [leaves[k] for k in FIELDS], allow_unused=True)
    return float(value.detach()), {k: torch.zeros_like(leaves[k]) if g is None else g
                          for k, g in zip(FIELDS, grads)}
