"""The plain reference of the ``train_2dgs`` cells: 2D Gaussian Splatting
(Huang et al., SIGGRAPH 2024, arXiv:2403.17888) as the benchmark's
configuration states it, its loss with both regularizers, its gradients and
Adam, in plain PyTorch.

Independent of the program: it imports neither ``jax``, the JAX package nor
the port, and takes only what the benchmark made. It follows the paper's
equations as ``configs/garden-2dgs.json`` fixes them (its ``assumed``
lists each departure), and no code of the port:

* projection: ``T = K [R_cw | t_cw] [[s_u t_u, s_v t_v, p], [0, 0, 1]]``
  (rows T_u, T_v, T_w; K of the pixel-centre convention); the low-pass
  filter's centre ``c`` from the 3-sigma disk's dual conic
  ``T diag(9, 9, -1) T^T``; the normal ``R_cw t_w`` turned to the camera;
  the cull (centre depth <= 0.2, the disk at 3 sigma or at the tile box's
  cutoff reaching the camera's plane, opacity under 1/255, dead); the tile
  box of every pixel at which the surfel can reach alpha 1/255: its disk
  out to ``k = sqrt(max(9, 2 ln(255 op)))`` sigmas and its filter's circle
  out to ``k / sqrt(2)`` pixels, padded by half a pixel; SH colour + 0.5
  with only red clamped at 0;
* the blend, per pixel of a tile, the surfels whose box covers it in
  (centre depth, index) order: ``k = x T_w - T_u``, ``l = y T_w - T_v``,
  ``h = k x l`` (skip where ``h_z = 0``), ``(u, v) = (h_x, h_y) / h_z``,
  ``G = exp(-min(u^2 + v^2, 2 |x - c|^2) / 2)``, ``z = T_w . (u, v, 1)``
  where the disk's term is the lesser, else the centre's depth ``T_w,z``
  (skip where ``z < 0.2``), the disk's term left out where the pixel's ray
  ``r`` grazes the disk's plane, ``|n . r| < 0.01 |r|``,
  ``alpha = min(0.99, op G)`` (skip under 1/255), weights ``w = alpha T``
  while the transmittance after the pair stays >= 1e-4; maps: colour,
  ``A = sum w``, ``D = sum w z``,
  ``N = sum w n`` and the distortion ``sum_i w_i sum_{j<i} w_j (m_i -
  m_j)^2``, ``m = 100 / 99.8 (1 - 0.2 / z)``, taken in one pass from the
  running sums;
* the loss: ``(1 - w) L1 + w (1 - SSIM)`` (``reference.loss``), plus
  ``lambda_dist`` times the mean distortion and ``lambda_normal`` times the
  mean of ``A - N . N~``, ``N~`` the normals of the expected depth
  ``D / A`` unprojected, from central differences on interior pixels;
* gradients by autograd, the blend in batches of tiles recomputed in the
  backward, so it fits at garden's size; Adam as ``reference.adam``.

Everything runs in the dtype of the parameters (float32 for the reference,
bfloat16 for the control), TF32 off. ``FAULTS`` plant what the calibration
asks the comparison to catch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from splatbench import reference

TILE = reference.TILE
NEAR, FAR = 0.2, 100.0
GRAZING = 1e-2
ALPHA_MAX, ALPHA_MIN, T_MIN = reference.ALPHA_MAX, reference.ALPHA_MIN, reference.T_MIN
PAIR_BUDGET = 1 << 23
# The planted faults: the low-pass filter dropped (G from the disk alone),
# the normals not turned to the camera, each pair's depth taken at the
# surfel's centre, the distortion's A m^2 term dropped.
FAULTS = ("no_filter", "no_flip", "centre_depth", "drop_am2")


def surfel_scene(conf: dict, seed: int, device) -> dict:
    """The configuration's surfels: ``inputs.make_scene``'s draws with the
    first two log-scales (``log_scales`` [N, 2])."""
    from splatbench import inputs

    scene = inputs.make_scene(conf, seed, device)
    scene["log_scales"] = scene["log_scales"][:, :2].contiguous()
    return scene


def _intrinsics(cam: dict):
    fx = cam["width"] / (2.0 * cam["tan_fovx"])
    fy = cam["height"] / (2.0 * cam["tan_fovy"])
    return fx, fy, (cam["width"] - 1) / 2.0, (cam["height"] - 1) / 2.0


def _quat_rot(q):
    q = q / torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], 1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], 1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], 1),
    ], 1)


def _conic(t, k2):
    """(centre [N, 2], half-extents [N, 2], C*_33 [N]) of the disk
    ``u^2 + v^2 <= k2`` under T [N, 3, 3]."""
    def dot(i, j):
        return k2 * (t[:, i, 0] * t[:, j, 0] + t[:, i, 1] * t[:, j, 1]) - t[:, i, 2] * t[:, j, 2]

    c33 = dot(2, 2)
    safe = torch.where(c33 < 0, c33, -torch.ones_like(c33))
    cx, cy = dot(0, 2) / safe, dot(1, 2) / safe
    hx = torch.sqrt(torch.clamp_min(cx * cx - dot(0, 0) / safe, 1e-4))
    hy = torch.sqrt(torch.clamp_min(cy * cy - dot(1, 1) / safe, 1e-4))
    return torch.stack([cx, cy], 1), torch.stack([hx, hy], 1), c33


def project(p: dict, cam: dict, sh_degree: int, fault: str | None = None) -> dict:
    """``attr`` [N, 18] (differentiable), ``depth`` [N], ``box`` [N, 4] int64
    tile box (x1, y1 exclusive), ``visible`` [N]."""
    m = p["means"]
    view = cam["view"]
    r_cw, t_cw = view[:3, :3], view[:3, 3]
    rot = _quat_rot(p["quats"])
    s = torch.exp(p["log_scales"])
    p_cam = m @ r_cw.T + t_cw
    axes = torch.einsum("ij,njk->nik", r_cw, rot)
    fx, fy, cx, cy = _intrinsics(cam)
    k = view.new_tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    cols = torch.stack([axes[:, :, 0] * s[:, :1], axes[:, :, 1] * s[:, 1:2], p_cam], -1)
    t = torch.einsum("ij,njk->nik", k, cols)  # [N, 3 rows, 3]
    n = axes[:, :, 2]
    if fault != "no_flip":
        turn = torch.where((n * p_cam).sum(1) > 0, -1.0, 1.0).to(n.dtype)
        n = n * turn[:, None].detach()
    centre, _, c33 = _conic(t, 9.0)
    opacity = torch.sigmoid(p["opacities"])
    w_img, h_img = cam["width"], cam["height"]
    tiles_x, tiles_y = -(-w_img // TILE), -(-h_img // TILE)
    with torch.no_grad():
        td = t.detach().double()
        k2 = torch.clamp_min(2.0 * torch.log(torch.clamp_min(opacity.detach().double(), 1e-30)
                                             / ALPHA_MIN), 9.0)
        e, h, c33_box = _conic(td, k2)
        rf = torch.sqrt(k2 / 2.0)[:, None]
        cd = centre.detach().double()
        lo = torch.minimum(e - h, cd - rf) - 0.5
        hi = torch.maximum(e + h, cd + rf) + 0.5
        finite = torch.isfinite(lo).all(1) & torch.isfinite(hi).all(1)
        lo = torch.where(finite[:, None], lo, torch.zeros_like(lo))
        hi = torch.where(finite[:, None], hi, torch.zeros_like(hi))
        box = torch.stack([
            torch.clamp(torch.floor(lo[:, 0] / TILE), 0, tiles_x),
            torch.clamp(torch.floor(lo[:, 1] / TILE), 0, tiles_y),
            torch.clamp(torch.floor(hi[:, 0] / TILE) + 1, 0, tiles_x),
            torch.clamp(torch.floor(hi[:, 1] / TILE) + 1, 0, tiles_y)], 1).to(torch.int64)
        area = (box[:, 2] - box[:, 0]).clamp_min(0) * (box[:, 3] - box[:, 1]).clamp_min(0)
        visible = (p["alive"] & (p_cam[:, 2].detach() > NEAR) & (c33.detach() < 0)
                   & (c33_box < 0) & finite & (opacity.detach() >= ALPHA_MIN) & (area > 0))
    d = m - cam["cam_pos"]
    d = d / torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
    kk = (sh_degree + 1) ** 2
    rgb = torch.einsum("nk,nkc->nc", reference._sh_basis(d)[:, :kk], p["sh"][:, :kk]) + 0.5
    rgb = torch.cat([rgb[:, :1].clamp_min(0.0), rgb[:, 1:]], dim=1)
    attr = torch.cat([t.reshape(-1, 9), centre, opacity[:, None], rgb, n], dim=1)
    return dict(attr=attr, depth=p_cam[:, 2].detach(), box=box, visible=visible)


def instances_needed(p: dict, cams: list, conf: dict) -> int:
    """The largest instance count over ``cams`` (the capacity probe)."""
    with torch.no_grad():
        return max(reference.instance_count(
            project(p, reference.camera(c, p["means"].dtype, p["means"].device),
                    conf["sh_degree"])) for c in cams)


def _batches(count):
    order = torch.argsort(count, descending=True)
    counts = count[order].tolist()
    i, n = 0, len(counts)
    while i < n and counts[i] > 0:
        k = counts[i]
        b = max(1, PAIR_BUDGET // (k * TILE * TILE))
        yield order[i:i + b], k
        i += b


def _blend(a, valid, px, py, intr, fault=None):
    """a [B, K, 18] in depth order, valid [B, K], pixel centres [B, P],
    ``intr`` the camera's (f_x, f_y, c_x, c_y). Returns (maps [B, P, 9],
    evaluated, contributing)."""
    t = a[..., None]  # [B, K, 18, 1]
    fx, fy, cx, cy = intr
    rx, ry = (px[:, None, :] - cx) / fx, (py[:, None, :] - cy) / fy
    grazing = (t[:, :, 15] * rx + t[:, :, 16] * ry + t[:, :, 17]).abs() \
        < GRAZING * torch.sqrt(rx * rx + ry * ry + 1.0)
    kx, ky, kz = (px[:, None, :] * t[:, :, 6 + i] - t[:, :, i] for i in range(3))
    lx, ly, lz = (py[:, None, :] * t[:, :, 6 + i] - t[:, :, 3 + i] for i in range(3))
    hx, hy, hz = ky * lz - kz * ly, kz * lx - kx * lz, kx * ly - ky * lx
    nz = hz != 0
    hz = torch.where(nz, hz, torch.ones_like(hz))
    u, v = hx / hz, hy / hz
    rho3 = u * u + v * v
    rho2 = 2.0 * ((t[:, :, 9] - px[:, None, :]) ** 2 + (t[:, :, 10] - py[:, None, :]) ** 2)
    use3 = (rho3 <= rho2) & ~grazing
    rho = rho3 if fault == "no_filter" else torch.where(use3, rho3, rho2)
    centre = t[:, :, 8].expand_as(u)
    z = torch.where(use3, t[:, :, 6] * u + t[:, :, 7] * v + t[:, :, 8], centre)
    if fault == "centre_depth":
        z = centre
    alpha = torch.clamp_max(t[:, :, 11] * torch.exp(-0.5 * rho), ALPHA_MAX)
    ok = valid[:, :, None] & nz & (z >= NEAR) & (alpha >= ALPHA_MIN)
    f = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
    t_incl = torch.cumprod(f, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    contrib = ok & (t_incl >= T_MIN)
    w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
    zs = torch.where(contrib, z, torch.ones_like(z))
    m = (FAR / (FAR - NEAR)) * (1.0 - NEAR / zs)

    def before(x):
        c = torch.cumsum(x, dim=1)
        return torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)

    am2 = 0.0 if fault == "drop_am2" else m * m * before(w)
    dist = (w * (am2 - 2.0 * m * before(w * m) + before(w * m * m))).sum(1)
    maps = torch.cat([torch.einsum("bkp,bkc->bpc", w, a[:, :, 12:15]),
                      w.sum(1)[..., None], (w * z).sum(1)[..., None],
                      torch.einsum("bkp,bkc->bpc", w, a[:, :, 15:18]), dist[..., None]], -1)
    with torch.no_grad():
        evaluated = int((ok & (t_excl >= T_MIN)).sum())
        contributing = int(contrib.sum())
    return maps, evaluated, contributing


def _tiles_to_image(tiles, bins, width, height):
    tx, ty = bins["tiles_x"], bins["tiles_y"]
    c = tiles.shape[-1]
    img = tiles.reshape(ty, tx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return img.reshape(ty * TILE, tx * TILE, c)[:height, :width]


def render(attr, bins, cam, fault=None):
    """The maps [H, W, 9] (no autograd) and the work counts."""
    width, height = cam["width"], cam["height"]
    num_tiles = bins["count"].shape[0]
    out = torch.zeros((num_tiles, TILE * TILE, 9), dtype=attr.dtype, device=attr.device)
    ev = co = 0
    with torch.no_grad():
        for tiles, k in _batches(bins["count"]):
            gid, valid, px, py = reference._batch_inputs(attr, bins, tiles, k)
            maps, e, c = _blend(attr[gid], valid, px, py, _intrinsics(cam), fault)
            out[tiles] = maps
            ev, co = ev + e, co + c
    return _tiles_to_image(out, bins, width, height), dict(evaluated=ev, contributing=co,
                                                           visible=bins["visible"])


def render_backward(attr, bins, d_maps, cam, fault=None):
    """d loss / d attr [N, 18] from d loss / d maps, recomputing the blend
    batch by batch under autograd."""
    tx, ty = bins["tiles_x"], bins["tiles_y"]
    h, w = d_maps.shape[:2]
    pad = torch.zeros((ty * TILE, tx * TILE, 9), dtype=d_maps.dtype, device=d_maps.device)
    pad[:h, :w] = d_maps
    d_tiles = pad.reshape(ty, TILE, tx, TILE, 9).permute(0, 2, 1, 3, 4).reshape(-1, TILE * TILE, 9)
    a = attr.detach().requires_grad_(True)
    for tiles, k in _batches(bins["count"]):
        gid, valid, px, py = reference._batch_inputs(attr, bins, tiles, k)
        with torch.enable_grad():
            maps, _, _ = _blend(a[gid], valid, px, py, _intrinsics(cam), fault)
            maps.backward(d_tiles[tiles])
    return a.grad if a.grad is not None else torch.zeros_like(attr)


def depth_normals(alpha, depth_sum, cam):
    """Normals of the expected depth ``D / A`` (0 where A = 0), unprojected,
    ``normalize((P[y+1] - P[y-1]) x (P[x+1] - P[x-1]))`` on interior
    pixels, 0 on the border: a fronto-parallel disk gives its own normal."""
    fx, fy, cx, cy = _intrinsics(cam)
    h, w = alpha.shape
    pos = alpha > 0
    z = torch.where(pos, depth_sum / torch.where(pos, alpha, torch.ones_like(alpha)),
                    torch.zeros_like(alpha))
    xs = (torch.arange(w, device=alpha.device, dtype=alpha.dtype) - cx) / fx
    ys = (torch.arange(h, device=alpha.device, dtype=alpha.dtype) - cy) / fy
    pts = torch.stack([z * xs[None, :], z * ys[:, None], z], -1)
    cross = torch.linalg.cross(pts[2:, 1:-1] - pts[:-2, 1:-1], pts[1:-1, 2:] - pts[1:-1, :-2],
                               dim=-1)
    n = cross / torch.clamp_min(torch.linalg.vector_norm(cross, dim=-1, keepdim=True), 1e-12)
    return F.pad(n, (0, 0, 1, 1, 1, 1))


def loss(maps, target, cam, mix: dict):
    """The photometric loss and both regularizers, weighted as the mix says."""
    photo = reference.loss(maps[..., 0:3], target, mix["ssim_weight"])
    n_depth = depth_normals(maps[..., 3], maps[..., 4], cam)
    l_n = maps[..., 3] - (maps[..., 5:8] * n_depth).sum(-1)
    return (photo + mix["lambda_dist"] * maps[..., 8].mean()
            + mix["lambda_normal"] * l_n.mean())


def train_step(p: dict, cam: dict, target, conf: dict, mix: dict, fault: str | None = None):
    """Loss and gradients of one view: (loss, grads, work counts)."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    leaves = {k: p[k].detach().requires_grad_(True) for k in reference.FIELDS}
    with torch.enable_grad():
        pr = project(dict(leaves, alive=p["alive"]), cam, conf["sh_degree"], fault)
    bins = reference.bin_tiles(pr, cam["width"], cam["height"])
    attr = pr["attr"]
    maps, pairs = render(attr.detach(), bins, cam, fault)
    maps = maps.requires_grad_(True)
    with torch.enable_grad():
        value = loss(maps, target, cam, mix)
        (d_maps,) = torch.autograd.grad(value, maps)
    d_attr = render_backward(attr, bins, d_maps, cam, fault)
    grads = torch.autograd.grad(attr, [leaves[k] for k in reference.FIELDS], d_attr,
                                allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(reference.FIELDS, grads)}
    return float(value.detach()), grads, pairs
