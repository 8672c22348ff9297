"""2D Gaussian surfels (2D Gaussian Splatting, Huang et al., SIGGRAPH 2024,
arXiv:2403.17888): their preprocess, the ray-splat blend with its depth,
normal, alpha and distortion maps, and their gradients.

A surfel k is an oriented planar disk: centre ``p``, tangent axes ``t_u``,
``t_v`` (columns 0 and 1 of ``R(q)``), axis ``t_w`` (column 2), scales
``s_u``, ``s_v``. With ``K`` the intrinsics in the port's pixel-centre
convention (``f_x = W / (2 tan_fovx)``, ``c_x = (W - 1) / 2``, as ndc2Pix of
the 3DGS path) and ``[R_cw | t_cw]`` the rows 0-2 of ``camera.view`` (the
shader frame: x right, y down, z forward),

    T = K [R_cw | t_cw] [[s_u t_u, s_v t_v, p], [0, 0, 1]]      (3 x 3)

maps ``(u, v, 1)`` to ``(x z, y z, z)``; its rows are ``T_u``, ``T_v``,
``T_w``. Preprocess writes a [18, N] table a surfel: ``T_u``, ``T_v``,
``T_w``; the centre ``c`` of the projected 3-sigma disk (from the dual
conic ``T diag(9, 9, -1) T^T``), which the low-pass filter is centred on;
the opacity; the SH colour (as the 3DGS path evaluates it); the normal
``n = R_cw t_w``, flipped to face the camera (``n . p_cam < 0``). It culls a
surfel whose centre lies at depth ``<= cfg.z_near_cull``, whose disk reaches
the camera's plane, or whose opacity lies under ``alpha_min``; its tile box
holds every pixel at which it can reach ``alpha_min`` (:func:`pixel_box`).

The blend, per pixel ``x = (x, y)`` front to back in the instance order
(tile, then centre depth): ``k = x T_w - T_u``, ``l = y T_w - T_v``,
``h = k x l`` (skipped where ``h_z = 0``), ``(u, v) = (h_x, h_y) / h_z``,
``rho3 = u^2 + v^2`` (``+inf`` where the pixel's ray ``r`` grazes the
disk's plane, ``|n . r| < GRAZING |r|``), ``rho2 = 2 |x - c|^2`` (the
filter, sigma^2 = 1/2), ``G = exp(-min(rho3, rho2) / 2)``, the depth
``z = T_w . (u, v, 1)`` where ``rho3 <= rho2``, else the centre's ``T_w,z`` (:func:`pair_terms`;
skipped where ``z < near``), ``alpha = min(0.99, op G)`` (skipped under
``alpha_min``), then the 3DGS path's transmittance rules. With the weight
``w = alpha T`` of each pair that adds colour, the nine maps are the
colour ``sum w c``, the alpha ``A = sum w``, the depth sum ``D = sum w z``,
the normal ``sum w n`` and the distortion ``sum_i w_i sum_{j<i} w_j
(m_i - m_j)^2``, ``m = far / (far - near) (1 - near / z)``, taken in the
same pass from the running sums ``A``, ``M1 = sum w m``, ``M2 = sum w m^2``:
pair i adds ``w_i (m_i^2 A - 2 m_i M1 + M2)`` before the sums take it.

Routes, as the 3DGS path's: a CPU tensor takes the plain versions
(:func:`preprocess2d_plain`, :func:`blend2d_plain` and autograd of it), a
CUDA tensor the kernels of ``csrc/preprocess2d.cu``,
``csrc/rasterize2d_forward.cu`` and ``csrc/rasterize2d_backward.cu`` (or the
call raises: so does a camera that requires grad where autograd records the
call, since the backward kernel writes no camera gradient).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpusplat_torch import trace
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops import _build
from tpusplat_torch.ops.binning import bin_and_sort
from tpusplat_torch.ops.preprocess import (CLAMP_MODES, CLAMPED_CHANNELS, _clamp_color,
                                           _degree, _sh_basis, quat_to_rotmat_cols)
from tpusplat_torch.ops.rasterize import _PackGather
from tpusplat_torch.types import Camera, SurfelParams

ATTR_ROWS = 18
S_TU, S_TV, S_TW, S_C, S_OP, S_RGB, S_N = 0, 3, 6, 9, 11, 12, 15
MAPS = 9  # colour 3, alpha, depth sum, normal 3, distortion
M_RGB, M_ALPHA, M_DEPTH, M_NORMAL, M_DIST = 0, 3, 4, 5, 8
CUTOFF = 3.0  # the disk's extent in sigmas for its centre (the paper's)
FILTER_INV_SQ = 2.0  # rho2 = 2 |x - c|^2: the low-pass filter's sigma^2 = 1/2
FAR = 100.0  # the distortion's far plane; its near is cfg.z_near_cull
BOX_PAD = 0.5  # pixels added to each side of a tile box (float32 rounding)
# The disk's term is left out where the cosine between a pixel's ray and the
# disk's normal is under GRAZING (within about half a degree of edge-on):
# there k and l are mostly cancellation, and the term and its gradients are
# rounding noise.
GRAZING = 1e-2
OUT_WORDS = 4 + ATTR_ROWS + 3  # the preprocess kernel's words a surfel

# C calls of each kernel since the last reset (chip_smoke.py reads them).
LAUNCHES = 0
BACKWARD_LAUNCHES = 0
FORWARD2D_LAUNCHES = 0
BACKWARD2D_LAUNCHES = 0


@dataclasses.dataclass
class ProcessedSurfels:
    """Per-surfel screen-space attributes (leading dim N; the table [18, N]).
    Culled surfels have ntiles == 0. The fields binning reads (depth, aabb,
    ntiles) are :class:`~tpusplat_torch.ops.preprocess.ProcessedGaussians`'."""

    table: torch.Tensor  # [18, N] T_u, T_v, T_w, c, opacity, colour, normal
    depth: torch.Tensor  # [N] view-space z of the centre
    aabb: torch.Tensor  # [N, 4] int32 tile box (x0, y0, x1, y1), x1/y1 exclusive
    ntiles: torch.Tensor  # [N] int32 (0 = culled)
    radius: torch.Tensor  # [N] the larger half-extent of the pixel box (0 = culled)


def intrinsics(camera: Camera):
    """(f_x, f_y, c_x, c_y) of the port's pixel-centre convention."""
    fx = camera.width / (2.0 * camera.tan_fovx)
    fy = camera.height / (2.0 * camera.tan_fovy)
    return fx, fy, (camera.width - 1) * 0.5, (camera.height - 1) * 0.5


def ray_intrinsics(camera: Camera) -> torch.Tensor:
    """[4] float32 (f_x, f_y, c_x, c_y) on the camera's device, from which
    the blend takes each pixel's ray (:func:`pixel_rays`)."""
    fx, fy, cx, cy = intrinsics(camera)
    return torch.stack([fx, fy, torch.full_like(fx, cx), torch.full_like(fy, cy)]).float()


def pixel_rays(px, py, intr):
    """The rays ``r = ((x - c_x) / f_x, (y - c_y) / f_y, 1)`` of the pixel
    centres ``px``, ``py``: (r_x, r_y, GRAZING |r|), as the blend kernels
    compute them."""
    rx = (px - intr[2]) / intr[0]
    ry = (py - intr[3]) / intr[1]
    return rx, ry, GRAZING * torch.sqrt(rx * rx + ry * ry + 1.0)


def box_cutoff_sq(opacity: torch.Tensor, alpha_min: float) -> torch.Tensor:
    """The squared extent, in sigmas of the disk and of the filter, beyond
    which ``op G < alpha_min``: ``max(9, 2 ln(op / alpha_min))``."""
    return torch.clamp_min(2.0 * torch.log(torch.clamp_min(opacity, 1e-30) / alpha_min),
                           CUTOFF * CUTOFF)


def dual_conic_box(tu, tv, tw, k2):
    """The centre and half-extents of the pixel box of the disk
    ``u^2 + v^2 <= k2`` under T (rows ``tu``, ``tv``, ``tw``, each a tuple of
    three [N] tensors), from ``C* = T diag(k2, k2, -1) T^T``: returns
    (cx, cy, hx, hy, c33); the box is valid where ``c33 < 0``."""
    def dot(a, b):
        return k2 * (a[0] * b[0] + a[1] * b[1]) - a[2] * b[2]

    c33 = dot(tw, tw)
    safe = torch.where(c33 < 0, c33, -torch.ones_like(c33))
    cx, cy = dot(tu, tw) / safe, dot(tv, tw) / safe
    hx = torch.sqrt(torch.clamp_min(cx * cx - dot(tu, tu) / safe, 1e-4))
    hy = torch.sqrt(torch.clamp_min(cy * cy - dot(tv, tv) / safe, 1e-4))
    return cx, cy, hx, hy, c33


def pixel_box(table: torch.Tensor, alpha_min: float):
    """[N, 4] (x lo, x hi, y lo, y hi), in pixel coordinates, of the pixels
    at which each surfel can reach ``alpha_min``: the box of its disk out to
    :func:`box_cutoff_sq` sigmas joined with its filter's circle out to the
    same (radius ``sqrt(k2 / 2)`` about ``c``), without the tile box's pad.
    Also returns the disk's ``c33`` at that cutoff. No gradient."""
    with torch.no_grad():
        t = table.detach()
        tu, tv, tw = (tuple(t[r + i] for i in range(3)) for r in (S_TU, S_TV, S_TW))
        k2 = box_cutoff_sq(t[S_OP], alpha_min)
        ex, ey, hx, hy, c33 = dual_conic_box(tu, tv, tw, k2)
        rf = torch.sqrt(k2 / FILTER_INV_SQ)
        cx, cy = t[S_C], t[S_C + 1]
        box = torch.stack([torch.minimum(ex - hx, cx - rf), torch.maximum(ex + hx, cx + rf),
                           torch.minimum(ey - hy, cy - rf), torch.maximum(ey + hy, cy + rf)],
                          dim=-1)
    return box, c33


def preprocess2d_plain(params: SurfelParams, camera: Camera,
                       cfg: RenderConfig) -> ProcessedSurfels:
    """Project all surfels for one camera, in plain PyTorch; the table is
    differentiable by autograd."""
    f32 = torch.float32
    means = params.means.to(f32)
    view = camera.view
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    pc = [view[r, 0] * mx + view[r, 1] * my + view[r, 2] * mz + view[r, 3] for r in range(3)]
    s = torch.exp(params.log_scales.to(f32))
    if cfg.scale_modifier != 1.0:
        s = s * cfg.scale_modifier
    q = params.quats.to(f32)
    qn = q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
    r = quat_to_rotmat_cols(qn)  # r00, r01, r02, r10, ...

    def to_cam(col):  # R_cw applied to column ``col`` of R
        return [view[i, 0] * r[col] + view[i, 1] * r[3 + col] + view[i, 2] * r[6 + col]
                for i in range(3)]

    a = [s[:, 0] * v for v in to_cam(0)]
    b = [s[:, 1] * v for v in to_cam(1)]
    n_cam = to_cam(2)
    fx, fy, cx, cy = intrinsics(camera)
    tu = (fx * a[0] + cx * a[2], fx * b[0] + cx * b[2], fx * pc[0] + cx * pc[2])
    tv = (fy * a[1] + cy * a[2], fy * b[1] + cy * b[2], fy * pc[1] + cy * pc[2])
    tw = (a[2], b[2], pc[2])
    facing = n_cam[0] * pc[0] + n_cam[1] * pc[1] + n_cam[2] * pc[2]
    sign = torch.where(facing > 0, -1.0, 1.0).detach()
    normal = [sign * v for v in n_cam]
    ccx, ccy, _, _, c33 = dual_conic_box(tu, tv, tw, CUTOFF * CUTOFF)
    opacity = torch.sigmoid(params.opacities.to(f32))

    d = means - camera.cam_pos
    dn = d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True))
    basis = _sh_basis(dn[..., 0], dn[..., 1], dn[..., 2], cfg.sh_degree)
    k = basis.shape[-1]
    color = _clamp_color(torch.sum(basis[..., None] * params.sh.to(f32)[..., :k, :], dim=-2)
                         + 0.5, cfg.color_clamp)
    table = torch.stack([*tu, *tv, *tw, ccx, ccy, opacity, color[:, 0], color[:, 1],
                         color[:, 2], *normal])
    return ProcessedSurfels(table=table, depth=pc[2],
                            **tile_box(table, pc[2].detach(), c33.detach(), params.alive, camera,
                                       cfg))


def tile_box(table, depth, c33, alive, camera: Camera, cfg: RenderConfig) -> dict:
    """aabb, ntiles and radius of the plain version (no gradient)."""
    tiles_x, tiles_y = cfg.tile_grid(camera.width, camera.height)
    with torch.no_grad():
        box, c33_box = pixel_box(table, cfg.alpha_min)
        lo_x, hi_x = box[:, 0] - BOX_PAD, box[:, 1] + BOX_PAD
        lo_y, hi_y = box[:, 2] - BOX_PAD, box[:, 3] + BOX_PAD
        finite = torch.isfinite(box).all(-1)
        lo_x, hi_x, lo_y, hi_y = (torch.where(finite, v, torch.zeros_like(v))
                                  for v in (lo_x, hi_x, lo_y, hi_y))
        x0 = torch.clamp(torch.floor(lo_x / cfg.tile_w), 0, tiles_x).to(torch.int32)
        y0 = torch.clamp(torch.floor(lo_y / cfg.tile_h), 0, tiles_y).to(torch.int32)
        x1 = torch.clamp(torch.floor(hi_x / cfg.tile_w) + 1, 0, tiles_x).to(torch.int32)
        y1 = torch.clamp(torch.floor(hi_y / cfg.tile_h) + 1, 0, tiles_y).to(torch.int32)
        ntiles = torch.clamp_min(x1 - x0, 0) * torch.clamp_min(y1 - y0, 0)
        visible = (alive & (depth > cfg.z_near_cull) & (c33 < 0) & (c33_box < 0) & finite
                   & (table[S_OP] >= cfg.alpha_min) & (ntiles > 0))
        ntiles = torch.where(visible, ntiles, torch.zeros_like(ntiles)).to(torch.int32)
        radius = torch.where(visible, 0.5 * torch.maximum(hi_x - lo_x, hi_y - lo_y),
                             torch.zeros_like(lo_x))
    return dict(aabb=torch.stack([x0, y0, x1, y1], dim=-1), ntiles=ntiles, radius=radius)


# -- the blend --


def pair_terms(a, px, py, rays, near: float):
    """The ray-splat terms of instances ``a`` ([18, ...] rows broadcast
    against the pixel centres ``px``, ``py`` and their ``rays``, from
    :func:`pixel_rays`): (u, v, rho3, rho2, z, ok) where ``ok`` is
    ``h_z != 0`` and ``z >= near``, and ``rho3`` is ``+inf`` where the ray
    grazes the disk's plane (``GRAZING``). The depth ``z`` is the ray's
    intersection with the disk's plane where ``rho3 <= rho2``, and the
    centre's depth ``T_w,z`` where the low-pass filter wins: there the disk
    is seen nearly edge-on, the intersection lies far outside it, and its
    depth swings with the least turn of the disk (the paper's code takes
    the centre's depth in that branch's gradient)."""
    kx, ky, kz = (px * a[S_TW + i] - a[S_TU + i] for i in range(3))
    lx, ly, lz = (py * a[S_TW + i] - a[S_TV + i] for i in range(3))
    hx = ky * lz - kz * ly
    hy = kz * lx - kx * lz
    hz = kx * ly - ky * lx
    rx, ry, graze = rays
    grazing = (a[S_N] * rx + a[S_N + 1] * ry + a[S_N + 2]).abs() < graze
    nz = hz != 0
    hz = torch.where(nz, hz, torch.ones_like(hz))
    u, v = hx / hz, hy / hz
    dx, dy = a[S_C] - px, a[S_C + 1] - py
    rho3 = torch.where(grazing, torch.full_like(u, float("inf")), u * u + v * v)
    rho2 = FILTER_INV_SQ * (dx * dx + dy * dy)
    z = torch.where(rho3 <= rho2, a[S_TW] * u + a[S_TW + 1] * v + a[S_TW + 2],
                    a[S_TW + 2].expand_as(u))
    return u, v, rho3, rho2, z, nz & (z >= near)


def distortion(w, m, a_before, m1_before, m2_before):
    """Each pixel's distortion [B, P] from its pairs' weights and ``m``
    [B, K, P] and the running sums before each pair: ``sum_i w_i (m_i^2 A_i
    - 2 m_i M1_i + M2_i)``."""
    return (w * (m * m * a_before - 2.0 * m * m1_before + m2_before)).sum(1)


def _blend_tiles_chunked(a, valid, px, py, intr, cfg: RenderConfig):
    """Blend K depth-ordered instances into P pixels for B tiles at once:
    ``a`` [18, B, K], ``valid`` [B, K], ``px``, ``py`` [B, P], ``intr``
    :func:`ray_intrinsics`. Returns (maps [B, P, 9], T [B, P], msum
    [B, P, 2])."""
    b, k = valid.shape
    p = px.shape[1]
    dt, dev = a.dtype, a.device
    maps = torch.zeros((b, p, MAPS), dtype=dt, device=dev)
    t_acc = torch.ones((b, p), dtype=dt, device=dev)
    s_a, s_m1, s_m2 = (torch.zeros((b, p), dtype=dt, device=dev) for _ in range(3))
    pxc, pyc = px[:, None, :], py[:, None, :]
    rays = pixel_rays(pxc, pyc, intr)
    near, scale = cfg.z_near_cull, FAR / (FAR - cfg.z_near_cull)
    for k0 in range(0, k, cfg.gauss_chunk):
        ch = a[:, :, k0:k0 + cfg.gauss_chunk, None]  # [18, B, ck, 1]
        _, _, rho3, rho2, z, ok = pair_terms(ch, pxc, pyc, rays, near)
        rho = torch.where(rho3 <= rho2, rho3, rho2)
        alpha = torch.clamp_max(ch[S_OP] * torch.exp(-0.5 * rho), cfg.alpha_max)
        ok = valid[:, k0:k0 + cfg.gauss_chunk, None] & ok & (alpha >= cfg.alpha_min)
        f = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
        t_incl = t_acc[:, None, :] * torch.cumprod(f, dim=1)
        t_excl = torch.cat([t_acc[:, None, :], t_incl[:, :-1]], dim=1)
        contrib = ok & (t_incl >= cfg.t_min)
        w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
        zs = torch.where(contrib, z, torch.ones_like(z))
        m = scale * (1.0 - near / zs)
        wm, wm2 = w * m, w * m * m

        def excl(x, carry):  # the running sum before each pair
            c = torch.cumsum(x, dim=1)
            return carry[:, None, :] + torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)

        dist = distortion(w, m, excl(w, s_a), excl(wm, s_m1), excl(wm2, s_m2))
        feats = torch.cat([ch[S_RGB:S_RGB + 3, :, :, 0], torch.ones_like(ch[S_OP, :, :, 0])[None],
                           torch.zeros_like(ch[S_OP, :, :, 0])[None], ch[S_N:S_N + 3, :, :, 0]])
        part = torch.einsum("bkp,fbk->bpf", w, feats)  # colour, alpha, -, normal
        depth = (w * z).sum(1)
        maps = maps + torch.cat([part[..., :4], depth[..., None], part[..., 5:8],
                                 dist[..., None]], dim=-1)
        s_a, s_m1, s_m2 = s_a + w.sum(1), s_m1 + wm.sum(1), s_m2 + wm2.sum(1)
        t_acc = t_incl[:, -1, :]
    return maps, t_acc, torch.stack([s_m1, s_m2], dim=-1)


def blend2d_plain(attr, starts, ends, intr, tiles_x: int, row0: int, width: int, crop_h: int,
                  cfg: RenderConfig):
    """Plain PyTorch forward blend of the [18, C] slab (differentiable),
    the camera's intrinsics ``intr`` (:func:`ray_intrinsics`).
    Returns (maps [crop_h, width, 9], tmap [crop_h, width], msum
    [crop_h, width, 2] (the totals M1, M2), tile_overflow); each tile takes
    at most ``cfg.max_per_tile`` instances, the excess counted in
    ``tile_overflow``."""
    num_tiles = starts.shape[0]
    nrows = num_tiles // tiles_x
    tw, th = cfg.tile_w, cfg.tile_h
    npx = tw * th
    cap = attr.shape[1]
    dev = attr.device
    counts = (ends - starts).long()
    tile_overflow = torch.clamp_min(counts - cfg.max_per_tile, 0).sum().to(torch.int32)
    counts = torch.clamp_max(counts, cfg.max_per_tile)
    lin = torch.arange(npx, device=dev)
    ly, lx = (lin // tw).to(attr.dtype), (lin % tw).to(attr.dtype)
    tb = cfg.tile_chunk
    batch_k = torch.nn.functional.pad(counts, (0, -num_tiles % tb)).reshape(-1, tb)
    parts = []
    for bi, k in enumerate(batch_k.max(dim=1).values.tolist()):
        tiles = torch.arange(bi * tb, min((bi + 1) * tb, num_tiles), device=dev)
        if k == 0:
            zero = torch.zeros((len(tiles), npx), dtype=attr.dtype, device=dev)
            parts.append((zero[..., None].expand(-1, -1, MAPS), zero + 1.0,
                          zero[..., None].expand(-1, -1, 2)))
            continue
        ks = torch.arange(k, device=dev)
        idx = torch.clamp_max(starts[tiles].long()[:, None] + ks[None, :], cap - 1)
        valid = ks[None, :] < counts[tiles][:, None]
        px = (tiles % tiles_x).to(attr.dtype)[:, None] * tw + lx[None, :]
        py = (row0 + tiles // tiles_x).to(attr.dtype)[:, None] * th + ly[None, :]
        parts.append(_blend_tiles_chunked(attr[:, idx], valid, px, py, intr, cfg))
    maps, tmap, msum = (_assemble(torch.cat([p[i] for p in parts]), nrows, tiles_x, tw, th,
                                  crop_h, width) for i in range(3))
    return maps, tmap, msum, tile_overflow


def _assemble(tiles, nrows: int, tiles_x: int, tw: int, th: int, crop_h: int, width: int):
    """Per-tile pixels [T, P, ...] -> [crop_h, width, ...]."""
    rest = tiles.shape[2:]
    img = tiles.reshape(nrows, tiles_x, th, tw, *rest).transpose(1, 2)
    return img.reshape(nrows * th, tiles_x * tw, *rest)[:crop_h, :width]


def backward2d_plain(attr, starts, ends, intr, d_maps, d_tmap, tiles_x: int, row0: int,
                     width: int, crop_h: int, cfg: RenderConfig):
    """d_attr [18, C] by autograd of :func:`blend2d_plain`, which recomputes
    the walk."""
    with torch.enable_grad():
        a = attr.detach().requires_grad_(True)
        maps, tmap, _, _ = blend2d_plain(a, starts, ends, intr, tiles_x, row0, width, crop_h,
                                         cfg)
        if not maps.requires_grad:
            return torch.zeros_like(attr)
        (d_attr,) = torch.autograd.grad((maps, tmap), (a,), (d_maps, d_tmap))
    return d_attr


def _check_blend(what, attr, starts, ends, intr, tiles_x, width, crop_h, cfg, **maps):
    num_tiles = starts.shape[0]
    npx = cfg.tile_w * cfg.tile_h
    if attr.dtype != torch.float32 or attr.dim() != 2 or attr.shape[0] != ATTR_ROWS \
            or not attr.is_contiguous() or attr.device.type != "cuda":
        raise ValueError(f"{what}: attr must be contiguous float32 [{ATTR_ROWS}, C] on a "
                         f"CUDA device, got {attr.dtype} {tuple(attr.shape)} on {attr.device}")
    for name, t in dict(starts=starts, ends=ends).items():
        if t.device != attr.device or t.dtype != torch.int32 or t.shape != (num_tiles,) \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int32 [{num_tiles}]")
    if intr.device != attr.device or intr.dtype != torch.float32 or intr.shape != (4,) \
            or not intr.is_contiguous():
        raise ValueError(f"{what}: intr must be contiguous float32 [4]")
    if num_tiles == 0 or num_tiles % tiles_x or not 0 < npx <= 256 or npx % 32:
        raise ValueError(f"{what}: {num_tiles} tiles, tiles_x {tiles_x}, {npx} pixels a tile")
    if crop_h > (num_tiles // tiles_x) * cfg.tile_h or width > tiles_x * cfg.tile_w:
        raise ValueError(f"{what}: the tiles do not cover the output")
    for name, (t, shape) in maps.items():
        if t.device != attr.device or t.dtype != torch.float32 or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32 {shape}")


def _forward2d_kernel():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("rasterize2d_forward", "tpusplat_forward2d",
                           [p, ctypes.c_longlong, p, p, p, i, i, i, i, i, i, i, f, f, f, f, f,
                            p, p, p, p])


def _backward2d_kernel():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("rasterize2d_backward", "tpusplat_backward2d",
                           [p, ctypes.c_longlong, p, p, p, i, i, i, i, i, i, i, f, f, f, f, f,
                            p, p, p, p, p, p, p])


def _consts(cfg: RenderConfig):
    return (cfg.alpha_max, cfg.alpha_min, cfg.t_min, cfg.z_near_cull, FAR)


def forward2d_cuda(attr, starts, ends, intr, tiles_x, row0, width, crop_h, cfg):
    """:func:`blend2d_plain`'s outputs from one launch of the forward kernel."""
    global FORWARD2D_LAUNCHES
    _check_blend("forward2d", attr, starts, ends, intr, tiles_x, width, crop_h, cfg)
    dev = attr.device
    maps = torch.empty((crop_h, width, MAPS), dtype=torch.float32, device=dev)
    tmap = torch.empty((crop_h, width), dtype=torch.float32, device=dev)
    msum = torch.empty((crop_h, width, 2), dtype=torch.float32, device=dev)
    err = _forward2d_kernel()(
        attr.data_ptr(), attr.stride(0), starts.data_ptr(), ends.data_ptr(), intr.data_ptr(),
        starts.shape[0], tiles_x, cfg.tile_w, cfg.tile_h, int(row0), width, crop_h,
        *_consts(cfg), maps.data_ptr(), tmap.data_ptr(), msum.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "forward2d blend kernel")
    FORWARD2D_LAUNCHES += 1
    return maps, tmap, msum, torch.zeros((), dtype=torch.int32, device=dev)


def backward2d_cuda(attr, starts, ends, intr, maps, tmap, msum, d_maps, d_tmap, tiles_x,
                    row0, width, crop_h, cfg):
    """d_attr [18, C] from one launch of the backward kernel; slots outside
    every tile range are left unwritten (the gather's backward drops them)."""
    global BACKWARD2D_LAUNCHES
    hw = (crop_h, width)
    _check_blend("backward2d", attr, starts, ends, intr, tiles_x, width, crop_h, cfg,
                 maps=(maps, (*hw, MAPS)), tmap=(tmap, hw), msum=(msum, (*hw, 2)),
                 d_maps=(d_maps, (*hw, MAPS)), d_tmap=(d_tmap, hw))
    d_attr = torch.empty_like(attr)
    err = _backward2d_kernel()(
        attr.data_ptr(), attr.stride(0), starts.data_ptr(), ends.data_ptr(), intr.data_ptr(),
        starts.shape[0], tiles_x, cfg.tile_w, cfg.tile_h, int(row0), width, crop_h,
        *_consts(cfg), maps.data_ptr(), tmap.data_ptr(), msum.data_ptr(), d_maps.data_ptr(),
        d_tmap.data_ptr(), d_attr.data_ptr(), _build.stream_ptr(attr.device))
    _build.check(err, "backward2d blend kernel")
    BACKWARD2D_LAUNCHES += 1
    return d_attr


class _RasterCore2d(torch.autograd.Function):
    """(maps, tmap, msum, tile_overflow) of the blend; the backward is the
    backward kernel on the card, autograd of the plain blend on the CPU."""

    @staticmethod
    def forward(ctx, attr, starts, ends, intr, tiles_x, row0, width, crop_h, cfg):
        fwd = blend2d_plain if attr.device.type == "cpu" else forward2d_cuda
        maps, tmap, msum, overflow = fwd(attr, starts, ends, intr, tiles_x, row0, width, crop_h,
                                         cfg)
        ctx.save_for_backward(attr, starts, ends, intr, maps, tmap, msum)
        ctx.static = (tiles_x, row0, width, crop_h, cfg)
        ctx.mark_non_differentiable(msum, overflow)
        return maps, tmap, msum, overflow

    @staticmethod
    def backward(ctx, d_maps, d_tmap, _d_msum, _d_overflow):
        attr, starts, ends, intr, maps, tmap, msum = ctx.saved_tensors
        d_maps = torch.zeros_like(maps) if d_maps is None else d_maps.contiguous()
        d_tmap = torch.zeros_like(tmap) if d_tmap is None else d_tmap.contiguous()
        if attr.device.type == "cpu":
            d_attr = backward2d_plain(attr, starts, ends, intr, d_maps, d_tmap, *ctx.static)
        else:
            d_attr = backward2d_cuda(attr, starts, ends, intr, maps, tmap, msum, d_maps, d_tmap,
                                     *ctx.static)
        return (d_attr,) + (None,) * 8


# -- preprocess on the card --

PARAM_SHAPES = dict(means=(3,), log_scales=(2,), quats=(4,), opacities=(), sh=(16, 3),
                    alive=())
CAMERA_SHAPES = dict(view=(4, 4), cam_pos=(3,), tan_fovx=(), tan_fovy=())
GRAD_FIELDS = ("means", "log_scales", "quats", "opacities", "sh")


def _preprocess2d_kernel():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("preprocess2d", "tpusplat_preprocess2d",
                           [p] * 10 + [i] * 9 + [f] * 3 + [p, p])


def _preprocess2d_backward_kernel():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("preprocess2d", "tpusplat_preprocess2d_backward",
                           [p] * 10 + [i] * 5 + [f] + [p] * 6)


def check_inputs(params: SurfelParams, camera: Camera) -> None:
    """Raise ``ValueError`` unless the inputs are what the kernels take:
    contiguous float32 (``alive`` bool), shaped as :class:`SurfelParams`
    and the camera say, on one CUDA device."""
    n = params.num_gaussians
    named = [(k, getattr(params, k), (n, *s)) for k, s in PARAM_SHAPES.items()]
    named += [(k, getattr(camera, k), s) for k, s in CAMERA_SHAPES.items()]
    dev = params.means.device
    for name, t, shape in named:
        dtype = torch.bool if name == "alive" else torch.float32
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"preprocess2d kernel: {name} must be contiguous {dtype} "
                             f"{list(shape)} on {dev}, got {t.dtype} {list(t.shape)} on "
                             f"{t.device}")
    if dev.type != "cuda":
        raise ValueError(f"preprocess2d kernel: no kernel for tensors on {dev}")


def _ptrs(params, camera, fields):
    return [getattr(params, k).data_ptr() for k in fields] + \
        [getattr(camera, k).data_ptr() for k in CAMERA_SHAPES]


def preprocess2d_cuda(params: SurfelParams, camera: Camera,
                      cfg: RenderConfig) -> ProcessedSurfels:
    """:func:`preprocess2d_plain`'s outputs from one launch of the forward
    kernel, as views of one buffer; no gradient flows through them."""
    global LAUNCHES
    check_inputs(params, camera)
    n = params.num_gaussians
    tiles_x, tiles_y = cfg.tile_grid(camera.width, camera.height)
    out = torch.empty(OUT_WORDS * n, dtype=torch.float32, device=params.means.device)
    err = _preprocess2d_kernel()(
        *_ptrs(params, camera, PARAM_SHAPES), n, camera.width, camera.height, cfg.tile_w,
        cfg.tile_h, tiles_x, tiles_y, _degree(cfg), CLAMP_MODES[cfg.color_clamp],
        cfg.scale_modifier, cfg.z_near_cull, cfg.alpha_min, out.data_ptr(),
        _build.stream_ptr(out.device))
    _build.check(err, "preprocess2d kernel")
    LAUNCHES += 1
    ints = out.view(torch.int32)
    rows = 4 + ATTR_ROWS
    return ProcessedSurfels(table=out[4 * n:rows * n].view(ATTR_ROWS, n),
                            depth=out[rows * n:(rows + 1) * n],
                            aabb=ints[:4 * n].view(n, 4),
                            radius=out[(rows + 1) * n:(rows + 2) * n],
                            ntiles=ints[(rows + 2) * n:(rows + 3) * n])


def preprocess2d_backward_cuda(params: SurfelParams, camera: Camera, cfg: RenderConfig,
                               d_table: torch.Tensor) -> dict:
    """The parameters' gradients from the table's, one launch of the
    backward kernel (which recomputes the forward's terms)."""
    global BACKWARD_LAUNCHES
    check_inputs(params, camera)
    n = params.num_gaussians
    if d_table.dtype != torch.float32 or tuple(d_table.shape) != (ATTR_ROWS, n) \
            or not d_table.is_contiguous() or d_table.device != params.means.device:
        raise ValueError(f"preprocess2d backward kernel: d_table must be contiguous float32 "
                         f"[{ATTR_ROWS}, {n}] on {params.means.device}")
    grads = {k: torch.empty_like(getattr(params, k)) for k in GRAD_FIELDS}
    err = _preprocess2d_backward_kernel()(
        *_ptrs(params, camera, GRAD_FIELDS), d_table.data_ptr(), n, camera.width,
        camera.height, _degree(cfg), CLAMPED_CHANNELS[cfg.color_clamp], cfg.scale_modifier,
        *(grads[k].data_ptr() for k in GRAD_FIELDS), _build.stream_ptr(d_table.device))
    _build.check(err, "preprocess2d backward kernel")
    BACKWARD_LAUNCHES += 1
    return grads


class _Preprocess2d(torch.autograd.Function):
    """The forward kernel's outputs, the table differentiable through the
    backward kernel."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, opacities, sh, params, camera, cfg):
        ps = preprocess2d_cuda(params, camera, cfg)
        ctx.mark_non_differentiable(ps.depth, ps.aabb, ps.ntiles, ps.radius)
        ctx.save_for_backward(means, log_scales, quats, opacities, sh)
        ctx.params, ctx.camera, ctx.cfg = params, camera, cfg
        return ps.table, ps.depth, ps.aabb, ps.ntiles, ps.radius

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_table, *_):
        params = dataclasses.replace(ctx.params, **dict(zip(GRAD_FIELDS, ctx.saved_tensors)))
        grads = preprocess2d_backward_cuda(params, ctx.camera, ctx.cfg, d_table.contiguous())
        return (*(grads[k] if need else None
                  for k, need in zip(GRAD_FIELDS, ctx.needs_input_grad)), None, None, None)


def preprocess2d(params: SurfelParams, camera: Camera, cfg: RenderConfig) -> ProcessedSurfels:
    """Project all surfels: the plain version on the CPU; else the forward
    kernel, with the backward kernel behind its table where autograd records
    the call. The backward kernel gives no camera gradient, so a CUDA camera
    that requires grad while autograd records raises ``ValueError``."""
    if params.device.type == "cpu":
        return preprocess2d_plain(params, camera, cfg)
    records = torch.is_grad_enabled()
    if records and any(getattr(camera, k).requires_grad for k in CAMERA_SHAPES):
        raise ValueError("preprocess2d kernel: no gradient for a camera that requires grad")
    if records and any(getattr(params, k).requires_grad for k in GRAD_FIELDS):
        table, depth, aabb, ntiles, radius = _Preprocess2d.apply(
            *(getattr(params, k) for k in GRAD_FIELDS), params, camera, cfg)
        return ProcessedSurfels(table=table, depth=depth, aabb=aabb, ntiles=ntiles,
                                radius=radius)
    return preprocess2d_cuda(params, camera, cfg)


# -- the pipeline --


def render_maps(params: SurfelParams, camera: Camera, cfg: RenderConfig):
    """preprocess -> bin and sort -> gather and blend, stamped as the 3DGS
    pipeline's stages. Returns (maps [H, W, 9], aux): aux as
    ``render_stages``' (transmittance, the overflow counters,
    num_instances, max_tile_count, visible, radius)."""
    dev = params.device
    trace.stage("preprocess", dev)
    ps = preprocess2d(params, camera, cfg)
    trace.stage("binning", dev)
    binned = bin_and_sort(ps, camera.width, camera.height, cfg)
    trace.stage("blend", dev)
    tiles_x, _ = cfg.tile_grid(camera.width, camera.height)
    attr = _PackGather.apply(trace.grad_stage(ps.table, "preprocess_bwd"), binned.gauss_id)
    maps, tmap, _, tile_overflow = _RasterCore2d.apply(
        attr, binned.tile_start, binned.tile_end, ray_intrinsics(camera), tiles_x, 0,
        camera.width, camera.height, cfg)
    counts = binned.tile_end - binned.tile_start
    aux = dict(transmittance=tmap, tile_overflow=tile_overflow,
               capacity_overflow=binned.overflow, gauss_overflow=binned.gauss_overflow,
               num_instances=binned.num_instances, max_tile_count=counts.max(),
               visible=ps.ntiles > 0, radius=ps.radius)
    return maps, aux


def split_maps(maps: torch.Tensor) -> dict:
    """The maps by name: rgb [H, W, 3], alpha [H, W], depth_sum [H, W],
    normal [H, W, 3] (the weighted sum, not normalised), distortion [H, W]."""
    return dict(rgb=maps[..., M_RGB:M_RGB + 3], alpha=maps[..., M_ALPHA],
                depth_sum=maps[..., M_DEPTH], normal=maps[..., M_NORMAL:M_NORMAL + 3],
                distortion=maps[..., M_DIST])


def render_stages2d(params: SurfelParams, camera: Camera, cfg: RenderConfig):
    """``render_stages`` for a surfel scene: (img [H, W, 3], aux), aux
    with the other maps under :func:`split_maps`' names."""
    maps, aux = render_maps(params, camera, cfg)
    named = split_maps(maps)
    aux.update({k: v for k, v in named.items() if k != "rgb"})
    return named["rgb"].contiguous(), aux

