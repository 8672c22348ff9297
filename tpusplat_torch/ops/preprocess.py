"""Per-Gaussian preprocessing: 3D covariance, EWA projection, SH color
(counterpart of ``tpusplat/ops/preprocess.py``).

One elementwise float32 pass over all N Gaussians. The JAX package computes
it outside Pallas, so there is no TPU kernel to port here; the port adds
two, the forward and its backward in ``csrc/preprocess.cu``.
:func:`preprocess` routes by what it can observe in its input:

  * a CUDA call that autograd records for the parameters alone (gradients
    enabled, some parameter requiring grad, no camera tensor requiring
    grad: the train steps, the densifying step, the sharded steps) runs
    :func:`preprocess_differentiable`: the forward kernel, whose [9, N]
    attribute table carries a gradient that the backward kernel turns into
    the five parameters' (:func:`preprocess_backward_cuda`);
  * a CUDA call where a camera tensor requires grad runs
    :func:`preprocess_plain`, the plain PyTorch version, differentiable by
    autograd (the kernels write no camera gradient);
  * every other CUDA call (``Session.draw``, ``render``, ``render_auto``,
    the trainer's evals, the viewers) launches the forward kernel alone
    through :func:`preprocess_cuda`;
  * a CPU call runs :func:`preprocess_plain`.

A CUDA call never falls back to the plain version: it launches or raises on
what the kernels do not take. All routes give the same outputs, the culls,
radius, aabb and ntiles bit for bit on the card. Every reference quirk is
kept:
  * view-space cull at z <= 0.2 (``preprocess.comp:135``)
  * Jacobian clamp at 1.3*tan_fov (``preprocess.comp:35-40``)
  * +0.3 dilation on the 2D covariance diagonal (``preprocess.comp:63-64``)
  * det <= 0 cull (``preprocess.comp:141``)
  * eigenvalue floor max(0.1, ...) and radius ceil(3 sqrt(lambda_max))
    (``preprocess.comp:148-152``), or the opacity-aware ``tight_radius``
  * ndc2Pix(v, S) = ((v+1)*S - 1)/2 (``preprocess.comp:110-113``)
  * SH adds +0.5 and clamps only the red channel (``preprocess.comp:102-104``)
"""

from __future__ import annotations

import ctypes
import dataclasses
from types import SimpleNamespace

import torch

from tpusplat_torch.config import SH_C0, SH_C1, SH_C2, SH_C3, RenderConfig
from tpusplat_torch.ops import _build
from tpusplat_torch.ops.activations import activate_opacity, activate_scales
from tpusplat_torch.types import Camera, GaussianParams


@dataclasses.dataclass
class ProcessedGaussians:
    """Per-Gaussian screen-space attributes (leading dim N). Culled
    Gaussians have ntiles == 0."""

    uv: torch.Tensor  # [N, 2] pixel-center coordinates
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # [N]
    color: torch.Tensor  # [N, 3]
    depth: torch.Tensor  # [N] view-space z
    aabb: torch.Tensor  # [N, 4] int32 tile box (x0, y0, x1, y1), x1/y1 exclusive
    ntiles: torch.Tensor  # [N] int32 overlapped-tile count (0 = culled)
    radius: torch.Tensor  # [N] pixel radius (0 = culled), float
    # The [9, N] table whose rows uv, conic, opacity and color view (the
    # kernel's outputs), or None where they are separate tensors.
    table: torch.Tensor | None = None


def quat_to_rotmat_cols(q: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The nine entries r00..r22 of the standard rotation matrix of (w,x,y,z)
    quaternions, each of shape [N] (``common.glsl:50-74``)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z),
        2 * (x * y - z * w),
        2 * (x * z + y * w),
        2 * (x * y + z * w),
        1 - 2 * (x * x + z * z),
        2 * (y * z - x * w),
        2 * (x * z - y * w),
        2 * (y * z + x * w),
        1 - 2 * (x * x + y * y),
    )


def _sh_basis(x, y, z, degree: int):
    """Real SH basis up to degree 3 (``common.glsl:16-33``, evaluation order
    ``preprocess.comp:80-100``). Returns [N, (degree+1)^2]."""
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [
            SH_C2[0] * x * y,
            SH_C2[1] * y * z,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * z * x,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        basis += [
            SH_C3[0] * (3.0 * xx - yy) * y,
            SH_C3[1] * x * y * z,
            SH_C3[2] * (4.0 * zz - xx - yy) * y,
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * (xx - yy) * z,
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(basis, dim=-1)


def _grad_sum(contributions):
    """A tensor's gradient from its consumers' contributions, listed in the
    order the forward created the consumers: autograd adds them up as its
    engine runs the consumers' backward, the last created first."""
    out = contributions[-1]
    for c in contributions[-2::-1]:
        out = out + c
    return out


def _sh_basis_backward(x, y, z, db: torch.Tensor, degree: int) -> torch.Tensor:
    """The gradient [N, 3] of the unit view direction (x, y, z) from the
    gradient ``db`` [N, K] of :func:`_sh_basis`, each product's gradient
    formed and added as autograd forms and adds it."""
    gx, gy, gz = [], [], []
    if degree >= 1:
        gy.append(db[:, 1] * -SH_C1)
        gz.append(db[:, 2] * SH_C1)
        gx.append(db[:, 3] * -SH_C1)
    if degree >= 2:
        d_q6, d_r8 = db[:, 6] * SH_C2[2], db[:, 8] * SH_C2[4]  # 2zz - xx - yy, xx - yy
        d_xx, d_yy, d_zz = _grad_sum([-d_q6, d_r8]), _grad_sum([-d_q6, -d_r8]), d_q6 * 2.0
        gx += [d_xx * x, d_xx * x, (db[:, 4] * y) * SH_C2[0], db[:, 7] * (SH_C2[3] * z)]
        gy += [d_yy * y, d_yy * y, db[:, 4] * (SH_C2[0] * x), (db[:, 5] * z) * SH_C2[1]]
        gz += [d_zz * z, d_zz * z, db[:, 5] * (SH_C2[1] * y), (db[:, 7] * x) * SH_C2[3]]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        a10 = SH_C3[1] * x
        d_b10 = db[:, 10] * z  # the gradient of (C31 x) y
        d_s9 = (db[:, 9] * y) * SH_C3[0]  # 3xx - yy
        d_s11 = (db[:, 11] * y) * SH_C3[2]  # 4zz - xx - yy
        d_s12 = db[:, 12] * (SH_C3[3] * z)  # 2zz - 3xx - 3yy
        d_s13 = db[:, 13] * (SH_C3[4] * x)  # 4zz - xx - yy
        d_r14 = (db[:, 14] * z) * SH_C3[5]  # xx - yy
        d_r15 = db[:, 15] * (SH_C3[6] * x)  # xx - 3yy
        d_xx = _grad_sum([d_s9 * 3.0, -d_s11, -d_s12 * 3.0, -d_s13, d_r14, d_r15])
        d_yy = _grad_sum([-d_s9, -d_s11, -d_s12 * 3.0, -d_s13, -d_r14, -d_r15 * 3.0])
        d_zz = _grad_sum([d_s11 * 4.0, d_s12 * 2.0, d_s13 * 4.0])
        gx += [d_xx * x, d_xx * x, (d_b10 * y) * SH_C3[1],
               (db[:, 13] * ((4.0 * zz - xx) - yy)) * SH_C3[4],
               (db[:, 15] * (xx - 3.0 * yy)) * SH_C3[6]]
        gy += [d_yy * y, d_yy * y, db[:, 9] * (SH_C3[0] * (3.0 * xx - yy)), d_b10 * a10,
               db[:, 11] * (SH_C3[2] * ((4.0 * zz - xx) - yy))]
        gz += [d_zz * z, d_zz * z, db[:, 10] * (a10 * y),
               (db[:, 12] * ((2.0 * zz - 3.0 * xx) - 3.0 * yy)) * SH_C3[3],
               db[:, 14] * (SH_C3[5] * (xx - yy))]
    zero = torch.zeros_like(x)
    return torch.stack([_grad_sum(g) if g else zero for g in (gx, gy, gz)], dim=-1)


def _forward_terms(params: GaussianParams, camera: Camera,
                   cfg: RenderConfig) -> SimpleNamespace:
    """The intermediates of the projection (``preprocess.comp:34-137``,
    ``precomp_cov3d.comp:31-47``) and the SH colour before its clamp
    (``preprocess.comp:72-104``), by name, as :func:`preprocess_plain`
    computes its outputs from them and :func:`preprocess_backward_plain`
    its gradients. Differentiable by autograd."""
    f32 = torch.float32
    means = params.means.to(f32)
    view, proj = camera.view, camera.proj

    # --- view/clip transforms (preprocess.comp:129-137) ---
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    tx, ty, depth = (view[r, 0] * mx + view[r, 1] * my + view[r, 2] * mz + view[r, 3]
                     for r in range(3))
    in_front = depth > cfg.z_near_cull
    p_hom_w = proj[3, 0] * mx + proj[3, 1] * my + proj[3, 2] * mz + proj[3, 3]
    # Guarded so culled lanes stay finite (the reference divides and culls).
    one = torch.ones_like(p_hom_w)
    p_w = 1.0 / torch.where(in_front, p_hom_w, one)
    pxn = proj[0, 0] * mx + proj[0, 1] * my + proj[0, 2] * mz + proj[0, 3]
    pyn = proj[1, 0] * mx + proj[1, 1] * my + proj[1, 2] * mz + proj[1, 3]
    ndc_x, ndc_y = pxn * p_w, pyn * p_w
    tz = torch.where(in_front, depth, one)

    # --- EWA 2D covariance (preprocess.comp:34-66) ---
    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    ux, uy = tx / tz, ty / tz
    uxc, uyc = torch.clamp(ux, -limx, limx), torch.clamp(uy, -limy, limy)
    txc, tyc = uxc * tz, uyc * tz
    focal_x = camera.width / (2.0 * camera.tan_fovx)
    focal_y = camera.height / (2.0 * camera.tan_fovy)
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    nfx_txc = -focal_x * txc
    j02 = nfx_txc * inv_z2
    j11 = focal_y * inv_z
    nfy_tyc = -focal_y * tyc
    j12 = nfy_tyc * inv_z2
    # M = J @ V3 (2x3), V3 = upper-left of the (flipped) view matrix.
    v = view
    m00 = j00 * v[0, 0] + j02 * v[2, 0]
    m01 = j00 * v[0, 1] + j02 * v[2, 1]
    m02 = j00 * v[0, 2] + j02 * v[2, 2]
    m10 = j11 * v[1, 0] + j12 * v[2, 0]
    m11 = j11 * v[1, 1] + j12 * v[2, 1]
    m12 = j11 * v[1, 2] + j12 * v[2, 2]

    # --- Sigma_3D = R S^2 R^T (precomp_cov3d.comp:31-47) ---
    s = activate_scales(params.log_scales.to(f32), cfg.scale_modifier)
    q = params.quats.to(f32)
    qinv = torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)  # normalize_quat's
    qn = q * qinv
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = quat_to_rotmat_cols(qn)
    ss0, ss1, ss2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    xx = r00 * r00 * ss0 + r01 * r01 * ss1 + r02 * r02 * ss2
    xy = r00 * r10 * ss0 + r01 * r11 * ss1 + r02 * r12 * ss2
    xz = r00 * r20 * ss0 + r01 * r21 * ss1 + r02 * r22 * ss2
    yy = r10 * r10 * ss0 + r11 * r11 * ss1 + r12 * r12 * ss2
    yz = r10 * r20 * ss0 + r11 * r21 * ss1 + r12 * r22 * ss2
    zz = r20 * r20 * ss0 + r21 * r21 * ss1 + r22 * r22 * ss2

    # cov2d = M Sigma M^T + dilation * I
    sm0x = xx * m00 + xy * m01 + xz * m02
    sm0y = xy * m00 + yy * m01 + yz * m02
    sm0z = xz * m00 + yz * m01 + zz * m02
    sm1x = xx * m10 + xy * m11 + xz * m12
    sm1y = xy * m10 + yy * m11 + yz * m12
    sm1z = xz * m10 + yz * m11 + zz * m12
    c_a = m00 * sm0x + m01 * sm0y + m02 * sm0z + cfg.dilation
    c_b = m10 * sm0x + m11 * sm0y + m12 * sm0z
    c_c = m10 * sm1x + m11 * sm1y + m12 * sm1z + cfg.dilation
    det = c_a * c_c - c_b * c_b
    inv_det = 1.0 / torch.where(det > 0.0, det, one)
    opacity = activate_opacity(params.opacities.to(f32))

    # --- SH colour before its clamp (preprocess.comp:72-104) ---
    d = means - camera.cam_pos
    dinv = torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True))
    dn = d * dinv
    basis = _sh_basis(dn[..., 0], dn[..., 1], dn[..., 2], cfg.sh_degree)  # [N, K]
    k = basis.shape[-1]
    color_raw = torch.sum(basis[..., None] * params.sh.to(f32)[..., :k, :], dim=-2) + 0.5
    return SimpleNamespace(**{name: t for name, t in locals().items()
                              if isinstance(t, torch.Tensor)})


# How many colour channels, from red on, ``clamp_min(0)`` clamps: only red
# (the reference quirk, preprocess.comp:102-104), all or none.
CLAMPED_CHANNELS = {"red": 1, "all": 3, "none": 0}


def _clamp_color(c: torch.Tensor, clamp: str) -> torch.Tensor:
    k = CLAMPED_CHANNELS[clamp]
    if k in (0, 3):
        return c.clamp_min(0.0) if k else c
    return torch.cat([c[..., :k].clamp_min(0.0), c[..., k:]], dim=-1)


def preprocess_plain(params: GaussianParams, camera: Camera,
                     cfg: RenderConfig) -> ProcessedGaussians:
    """Project all Gaussians for one camera, in plain PyTorch.
    Differentiable by autograd."""
    t = _forward_terms(params, camera, cfg)
    tiles_x, tiles_y = cfg.tile_grid(camera.width, camera.height)
    conic = torch.stack([t.c_c * t.inv_det, -t.c_b * t.inv_det, t.c_a * t.inv_det], dim=-1)
    visible = t.in_front & (t.det > 0.0)

    # --- radius from max eigenvalue (preprocess.comp:148-152) ---
    mid = 0.5 * (t.c_a + t.c_c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - t.det, 0.1))
    lam = mid + disc
    opacity = t.opacity
    ref_radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))
    if cfg.tight_radius:
        # Opacity-aware extent (see the JAX package's preprocess): every
        # excluded pixel has alpha < 1/255, so the image is unchanged.
        mult2 = 2.0 * torch.log(torch.clamp_min(255.0 * opacity, 1e-12))
        r_tight = torch.ceil(
            torch.sqrt(torch.clamp_min(lam, 0.0) * torch.clamp_min(mult2, 0.0))
        ) + 2.0
        radius = torch.where(
            255.0 * opacity < 1.0, torch.zeros_like(lam), torch.minimum(ref_radius, r_tight)
        )
    else:
        radius = ref_radius

    # --- pixel center and tile AABB (preprocess.comp:155-165) ---
    uv_x = ((t.ndc_x + 1.0) * camera.width - 1.0) * 0.5
    uv_y = ((t.ndc_y + 1.0) * camera.height - 1.0) * 0.5
    uv = torch.stack([uv_x, uv_y], dim=-1)

    with torch.no_grad():
        rad = radius.detach()
        ux, uy = uv_x.detach(), uv_y.detach()
        x0 = torch.clamp(torch.floor((ux - rad) / cfg.tile_w), 0, tiles_x).to(torch.int32)
        y0 = torch.clamp(torch.floor((uy - rad) / cfg.tile_h), 0, tiles_y).to(torch.int32)
        x1 = torch.clamp(
            torch.floor((ux + rad + cfg.tile_w - 1) / cfg.tile_w), 0, tiles_x
        ).to(torch.int32)
        y1 = torch.clamp(
            torch.floor((uy + rad + cfg.tile_h - 1) / cfg.tile_h), 0, tiles_y
        ).to(torch.int32)
        ntiles = torch.clamp_min(x1 - x0, 0) * torch.clamp_min(y1 - y0, 0)

        # radius == 0 marks an invisible Gaussian (reachable with tight_radius).
        visible = visible & params.alive & (ntiles > 0) & (rad > 0)
        ntiles = torch.where(visible, ntiles, torch.zeros_like(ntiles)).to(torch.int32)
    radius = torch.where(visible, radius, torch.zeros_like(radius))

    color = _clamp_color(t.color_raw, cfg.color_clamp)
    return ProcessedGaussians(
        uv=uv,
        conic=conic,
        opacity=opacity,
        color=color,
        depth=t.depth,
        aabb=torch.stack([x0, y0, x1, y1], dim=-1),
        ntiles=ntiles,
        radius=radius,
    )


@torch.no_grad()
def preprocess_backward_plain(params: GaussianParams, camera: Camera, cfg: RenderConfig,
                              d_table: torch.Tensor) -> dict:
    """The gradients of ``means``, ``log_scales``, ``quats``, ``opacities``
    and ``sh`` from the gradient ``d_table`` [9, N] of the attribute table
    (rows uv, conic, opacity, color), written out by hand on the forward's
    intermediates recomputed: the backward kernel's arithmetic in plain
    PyTorch. It is autograd of :func:`preprocess_plain` op for op, each
    product's gradient formed as autograd forms it and a tensor's
    contributions added in the order autograd adds them (on the CPU the two
    agree bit for bit), every mask kept: the Jacobian clamp passes where
    ``-lim <= t <= lim``, the depth guard where ``z > z_near_cull``, the
    det guard where ``det > 0``, the colour clamp where ``c >= 0``; the SH
    coefficients the degree leaves unused get zeros."""
    t = _forward_terms(params, camera, cfg)
    g = [d_table[i].to(torch.float32) for i in range(9)]
    zero = torch.zeros_like(t.tz)
    v, p = camera.view, camera.proj

    d_opacities = (g[5] * (1.0 - t.opacity)) * t.opacity  # torch.sigmoid's backward

    # --- SH colour: the clamp's mask, the coefficients, the basis ---
    dc = torch.stack([torch.where(t.color_raw[:, c] >= 0.0, g[6 + c], zero)
                      if c < CLAMPED_CHANNELS[cfg.color_clamp] else g[6 + c]
                      for c in range(3)], dim=-1)
    sh = params.sh.to(torch.float32)
    k = t.basis.shape[-1]
    d_sh = torch.zeros_like(sh)
    d_sh[:, :k] = dc[:, None, :] * t.basis[:, :, None]
    d_dn = _sh_basis_backward(t.dn[:, 0], t.dn[:, 1], t.dn[:, 2],
                              (dc[:, None, :] * sh[:, :k]).sum(-1), cfg.sh_degree)
    # the direction d * rsqrt(|d|^2), d = means - cam_pos
    d_sq = (-0.5 * (d_dn * t.d).sum(-1, keepdim=True)) * t.dinv.pow(3)
    d_d = _grad_sum([d_sq * t.d, d_sq * t.d, d_dn * t.dinv])

    # --- conic = (c_c, -c_b, c_a) / det, det guarded where det <= 0 ---
    d_inv = _grad_sum([g[2] * t.c_c, g[3] * -t.c_b, g[4] * t.c_a])
    d_det = torch.where(t.det > 0.0, -d_inv * (t.inv_det * t.inv_det), zero)
    d_ca = _grad_sum([d_det * t.c_c, g[4] * t.inv_det])
    d_cb = _grad_sum([-d_det * t.c_b, -d_det * t.c_b, -(g[3] * t.inv_det)])
    d_cc = _grad_sum([d_det * t.c_a, g[2] * t.inv_det])

    # --- cov2d = M Sigma M^T through sm0 = Sigma M0 and sm1 = Sigma M1 ---
    d_sm0x = _grad_sum([d_ca * t.m00, d_cb * t.m10])
    d_sm0y = _grad_sum([d_ca * t.m01, d_cb * t.m11])
    d_sm0z = _grad_sum([d_ca * t.m02, d_cb * t.m12])
    d_sm1x, d_sm1y, d_sm1z = d_cc * t.m10, d_cc * t.m11, d_cc * t.m12
    d_m00 = _grad_sum([d_sm0x * t.xx, d_sm0y * t.xy, d_sm0z * t.xz, d_ca * t.sm0x])
    d_m01 = _grad_sum([d_sm0x * t.xy, d_sm0y * t.yy, d_sm0z * t.yz, d_ca * t.sm0y])
    d_m02 = _grad_sum([d_sm0x * t.xz, d_sm0y * t.yz, d_sm0z * t.zz, d_ca * t.sm0z])
    d_m10 = _grad_sum([d_sm1x * t.xx, d_sm1y * t.xy, d_sm1z * t.xz, d_cb * t.sm0x,
                       d_cc * t.sm1x])
    d_m11 = _grad_sum([d_sm1x * t.xy, d_sm1y * t.yy, d_sm1z * t.yz, d_cb * t.sm0y,
                       d_cc * t.sm1y])
    d_m12 = _grad_sum([d_sm1x * t.xz, d_sm1y * t.yz, d_sm1z * t.zz, d_cb * t.sm0z,
                       d_cc * t.sm1z])
    d_cov = dict(
        xx=_grad_sum([d_sm0x * t.m00, d_sm1x * t.m10]),
        xy=_grad_sum([d_sm0x * t.m01, d_sm0y * t.m00, d_sm1x * t.m11, d_sm1y * t.m10]),
        xz=_grad_sum([d_sm0x * t.m02, d_sm0z * t.m00, d_sm1x * t.m12, d_sm1z * t.m10]),
        yy=_grad_sum([d_sm0y * t.m01, d_sm1y * t.m11]),
        yz=_grad_sum([d_sm0y * t.m02, d_sm0z * t.m01, d_sm1y * t.m12, d_sm1z * t.m11]),
        zz=_grad_sum([d_sm0z * t.m02, d_sm1z * t.m12]))

    # --- M = J V3; J from 1 / tz and the clamped tx, ty ---
    d_j00 = _grad_sum([d_m00 * v[0, 0], d_m01 * v[0, 1], d_m02 * v[0, 2]])
    d_j02 = _grad_sum([d_m00 * v[2, 0], d_m01 * v[2, 1], d_m02 * v[2, 2]])
    d_j11 = _grad_sum([d_m10 * v[1, 0], d_m11 * v[1, 1], d_m12 * v[1, 2]])
    d_j12 = _grad_sum([d_m10 * v[2, 0], d_m11 * v[2, 1], d_m12 * v[2, 2]])
    d_inv_z2 = _grad_sum([d_j02 * t.nfx_txc, d_j12 * t.nfy_tyc])
    d_inv_z = _grad_sum([d_inv_z2 * t.inv_z, d_inv_z2 * t.inv_z, d_j00 * t.focal_x,
                         d_j11 * t.focal_y])
    d_txc = (d_j02 * t.inv_z2) * -t.focal_x
    d_tyc = (d_j12 * t.inv_z2) * -t.focal_y
    # the clamp passes where -lim <= t <= lim, inclusive (clamp's backward)
    d_ux = torch.where((t.ux >= -t.limx) & (t.ux <= t.limx), d_txc * t.tz, zero)
    d_uy = torch.where((t.uy >= -t.limy) & (t.uy <= t.limy), d_tyc * t.tz, zero)
    d_tz = _grad_sum([-d_ux * (t.ux / t.tz), -d_uy * (t.uy / t.tz), d_txc * t.uxc,
                      d_tyc * t.uyc, -d_inv_z * (t.inv_z * t.inv_z)])
    d_tx, d_ty = d_ux / t.tz, d_uy / t.tz
    d_depth = torch.where(t.in_front, d_tz, zero)

    # --- uv = ((ndc + 1) S - 1) / 2, ndc = (P m) / w, w guarded behind z_near_cull ---
    d_ndcx = (g[0] * 0.5) * camera.width
    d_ndcy = (g[1] * 0.5) * camera.height
    d_pw = _grad_sum([d_ndcx * t.pxn, d_ndcy * t.pyn])
    d_phw = torch.where(t.in_front, -d_pw * (t.p_w * t.p_w), zero)
    d_pxn, d_pyn = d_ndcx * t.p_w, d_ndcy * t.p_w
    d_means = torch.stack([d_d[:, c] + _grad_sum([
        d_tx * v[0, c], d_ty * v[1, c], d_depth * v[2, c], d_phw * p[3, c], d_pxn * p[0, c],
        d_pyn * p[1, c]]) for c in range(3)], dim=-1)

    # --- Sigma = sum_c ss_c R[:, c] R[:, c]^T: the scales, then R ---
    r = [[t.r00, t.r01, t.r02], [t.r10, t.r11, t.r12], [t.r20, t.r21, t.r22]]
    d_r = [[None] * 3 for _ in range(3)]
    d_s = []
    for c, ss in enumerate((t.ss0, t.ss1, t.ss2)):
        r0, r1, r2 = r[0][c], r[1][c], r[2][c]
        a = {e: d_cov[e] * ss for e in d_cov}
        d_ss = _grad_sum([d_cov["xx"] * (r0 * r0), d_cov["xy"] * (r0 * r1),
                          d_cov["xz"] * (r0 * r2), d_cov["yy"] * (r1 * r1),
                          d_cov["yz"] * (r1 * r2), d_cov["zz"] * (r2 * r2)])
        d_r[0][c] = _grad_sum([a["xx"] * r0, a["xx"] * r0, a["xy"] * r1, a["xz"] * r2])
        d_r[1][c] = _grad_sum([a["xy"] * r0, a["yy"] * r1, a["yy"] * r1, a["yz"] * r2])
        d_r[2][c] = _grad_sum([a["xz"] * r0, a["yz"] * r1, a["zz"] * r2, a["zz"] * r2])
        d_s.append(d_ss * (2.0 * t.s[:, c]))
    d_s = torch.stack(d_s, dim=-1)
    if cfg.scale_modifier != 1.0:
        d_s = d_s * cfg.scale_modifier
    d_log_scales = d_s * torch.exp(params.log_scales.to(torch.float32))

    # --- R of the unit quaternion (w, x, y, z), then q * rsqrt(|q|^2 + eps) ---
    w, x, y, z = t.qn[:, 0], t.qn[:, 1], t.qn[:, 2], t.qn[:, 3]
    (d00, d01, d02), (d10, d11, d12), (d20, d21, d22) = d_r
    k00, k11, k22 = -d00 * 2, -d11 * 2, -d22 * 2  # 1 - 2 (a a + b b)
    k01, k02, k10, k12, k20, k21 = d01 * 2, d02 * 2, d10 * 2, d12 * 2, d20 * 2, d21 * 2
    d_qn = torch.stack([
        _grad_sum([-k01 * z, k02 * y, k10 * z, -k12 * x, -k20 * y, k21 * x]),
        _grad_sum([k01 * y, k02 * z, k10 * y, k11 * x, k11 * x, -k12 * w, k20 * z, k21 * w,
                   k22 * x, k22 * x]),
        _grad_sum([k00 * y, k00 * y, k01 * x, k02 * w, k10 * x, k12 * z, -k20 * w, k21 * z,
                   k22 * y, k22 * y]),
        _grad_sum([k00 * z, k00 * z, -k01 * w, k02 * x, k10 * w, k11 * z, k11 * z, k12 * y,
                   k20 * x, k21 * y]),
    ], dim=-1)
    q = params.quats.to(torch.float32)
    d_qsq = (-0.5 * (d_qn * q).sum(-1, keepdim=True)) * t.qinv.pow(3)
    d_quats = _grad_sum([d_qsq * q, d_qsq * q, d_qn * t.qinv])

    return dict(means=d_means, log_scales=d_log_scales, quats=d_quats,
                opacities=d_opacities, sh=d_sh)


# C calls of the forward and the backward kernel since the last reset
# (chip_smoke.py reads them).
LAUNCHES = 0
BACKWARD_LAUNCHES = 0
CLAMP_MODES = {"red": 0, "all": 1, "none": 2}
# Trailing shapes of the inputs (float32, alive bool), and which of them the
# kernel reads with 16-byte loads.
PARAM_SHAPES = dict(means=(3,), log_scales=(3,), quats=(4,), opacities=(), sh=(16, 3),
                    alive=())
CAMERA_SHAPES = dict(view=(4, 4), proj=(4, 4), cam_pos=(3,), tan_fovx=(), tan_fovy=())
ALIGNED = ("quats", "sh")
# The parameters that carry a gradient, in the backward kernel's order.
GRAD_FIELDS = ("means", "log_scales", "quats", "opacities", "sh")
# Words a Gaussian of the kernel's output buffer, field by field: aabb [N, 4]
# int32, the blend's [9, N] attribute table (uv, conic, opacity and color as
# rows), depth, radius, ntiles (int32).
OUT_WORDS = 16


def preprocess(params: GaussianParams, camera: Camera, cfg: RenderConfig) -> ProcessedGaussians:
    """Project all Gaussians for one camera: through :func:`preprocess_plain`
    on the CPU and where a camera tensor requires grad; through the
    kernels with the table differentiable (:func:`preprocess_differentiable`)
    where autograd records the call for the parameters; else through the
    forward kernel alone (:func:`preprocess_cuda`)."""
    if params.device.type == "cpu" or _records_grad(camera, CAMERA_SHAPES):
        return preprocess_plain(params, camera, cfg)
    if _records_grad(params, PARAM_SHAPES):
        return preprocess_differentiable(params, camera, cfg)
    return preprocess_cuda(params, camera, cfg)


def _records_grad(obj, shapes: dict) -> bool:
    """Whether autograd would record a call for these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(obj, shapes))


def _tensors(obj, shapes: dict) -> list:
    return [getattr(obj, name) for name in shapes]


def _kernel():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("preprocess", "tpusplat_preprocess",
                           [p] * 11 + [i] * 10 + [f] * 3 + [p, p])


def _backward_kernel():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("preprocess", "tpusplat_preprocess_backward",
                           [p] * 11 + [i] * 5 + [f] * 3 + [p] * 6)


def check_inputs(params: GaussianParams, camera: Camera) -> None:
    """Raise ``ValueError`` unless the inputs are what the kernels take:
    float32 (``alive`` bool), contiguous, shaped as ``GaussianParams`` and
    ``Camera`` say, ``quats`` and ``sh`` 16-byte aligned, all on one CUDA
    device."""
    n = params.num_gaussians
    named = [*zip(PARAM_SHAPES, _tensors(params, PARAM_SHAPES), PARAM_SHAPES.values()),
             *zip(CAMERA_SHAPES, _tensors(camera, CAMERA_SHAPES), CAMERA_SHAPES.values())]
    for name, t, trailing in named:
        shape = (n, *trailing) if name in PARAM_SHAPES else trailing
        dtype = torch.bool if name == "alive" else torch.float32
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"preprocess kernel: {name} must be contiguous {dtype} "
                             f"{list(shape)}, got {t.dtype} {list(t.shape)}"
                             f"{'' if t.is_contiguous() else ' not contiguous'}")
        if name in ALIGNED and t.data_ptr() % 16:
            raise ValueError(f"preprocess kernel: {name} must be 16-byte aligned")
    dev = params.means.device
    if dev.type != "cuda":
        raise ValueError(f"preprocess kernel: no kernel for tensors on {dev}")
    if any(t.device != dev for _, t, _ in named):
        raise ValueError("preprocess kernel: the parameters and the camera must lie on one "
                         f"device, got {sorted({str(t.device) for _, t, _ in named})}")
    if camera.width <= 0 or camera.height <= 0:
        raise ValueError(f"preprocess kernel: frame {camera.width}x{camera.height}")


def preprocess_cuda(params: GaussianParams, camera: Camera,
                    cfg: RenderConfig) -> ProcessedGaussians:
    """:func:`preprocess_plain`'s outputs from one launch of the kernel
    (``csrc/preprocess.cu``): no gradient flows through them. Raises
    ``ValueError`` on inputs the kernel does not take (:func:`check_inputs`)."""
    check_inputs(params, camera)
    n = params.num_gaussians
    out = torch.empty(OUT_WORDS * n, dtype=torch.float32, device=params.means.device)
    launch(params, camera, cfg, out)
    return output_fields(out, n)


def launch(params: GaussianParams, camera: Camera, cfg: RenderConfig,
           out: torch.Tensor) -> None:
    """One C call of the kernel into ``out`` ([16 N] float32) on checked
    inputs, counted in ``LAUNCHES``."""
    global LAUNCHES
    tiles_x, tiles_y = cfg.tile_grid(camera.width, camera.height)
    ptrs = [t.data_ptr() for t in (*_tensors(params, PARAM_SHAPES),
                                   *_tensors(camera, CAMERA_SHAPES))]
    err = _kernel()(
        *ptrs, params.num_gaussians, camera.width, camera.height, cfg.tile_w, cfg.tile_h,
        tiles_x, tiles_y, _degree(cfg), CLAMP_MODES[cfg.color_clamp], int(cfg.tight_radius),
        cfg.scale_modifier, cfg.z_near_cull, cfg.dilation, out.data_ptr(),
        _build.stream_ptr(out.device))
    _build.check(err, "preprocess kernel")
    LAUNCHES += 1


def _degree(cfg: RenderConfig) -> int:
    return min(max(cfg.sh_degree, 0), 3)  # the degrees the plain basis has


def output_fields(out: torch.Tensor, n: int) -> ProcessedGaussians:
    """The kernel's output buffer as :class:`ProcessedGaussians`, each field
    a view of it: uv, conic, opacity and color are row views of the [9, N]
    table (uv and conic and color transposed, so not contiguous), the rest
    contiguous."""
    ints = out.view(torch.int32)
    return _fields(out[4 * n:13 * n].view(9, n), ints[:4 * n].view(n, 4),
                   ints[15 * n:16 * n], out[13 * n:14 * n], out[14 * n:15 * n])


def _fields(table, aabb, ntiles, depth, radius) -> ProcessedGaussians:
    return ProcessedGaussians(uv=table[0:2].T, conic=table[2:5].T, opacity=table[5],
                              color=table[6:9].T, depth=depth, aabb=aabb, ntiles=ntiles,
                              radius=radius, table=table)


def attribute_table(pg: ProcessedGaussians) -> torch.Tensor:
    """[9, N]: uv, conic, opacity and color as rows, the table the blend
    gathers from: the kernel's table as it lies, or the plain version's
    fields concatenated (autograd's graph included)."""
    if pg.table is not None:
        return pg.table
    return torch.cat((pg.uv.T, pg.conic.T, pg.opacity[None, :], pg.color.T), dim=0)


class _Preprocess(torch.autograd.Function):
    """The forward kernel's outputs, the [9, N] table differentiable (its
    gradient the backward kernel's input), aabb, ntiles, depth and radius
    not: the plain version's graph gives them no gradient that reaches a
    parameter."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, opacities, sh, params, camera, cfg):
        pg = preprocess_cuda(params, camera, cfg)
        ctx.mark_non_differentiable(pg.aabb, pg.ntiles, pg.depth, pg.radius)
        ctx.save_for_backward(means, log_scales, quats, opacities, sh)
        ctx.params, ctx.camera, ctx.cfg = params, camera, cfg
        return pg.table, pg.aabb, pg.ntiles, pg.depth, pg.radius

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_table, *_):
        params = dataclasses.replace(ctx.params, **dict(zip(GRAD_FIELDS, ctx.saved_tensors)))
        grads = preprocess_backward_cuda(params, ctx.camera, ctx.cfg, d_table.contiguous())
        return (*(grads[k] if need else None
                  for k, need in zip(GRAD_FIELDS, ctx.needs_input_grad)), None, None, None)


def preprocess_differentiable(params: GaussianParams, camera: Camera,
                              cfg: RenderConfig) -> ProcessedGaussians:
    """:func:`preprocess_cuda`'s outputs, with the gradient of the table's
    rows (uv, conic, opacity, color) reaching the parameters through the
    backward kernel (:func:`preprocess_backward_cuda`); ``table`` is the
    differentiable output itself, so the blend's gather takes it without an
    ``as_strided`` or a ``cat`` in autograd's graph. The camera gets no
    gradient. Raises ``ValueError`` as :func:`preprocess_cuda` does."""
    return _fields(*_Preprocess.apply(*_tensors(params, GRAD_FIELDS), params, camera, cfg))


def preprocess_backward_cuda(params: GaussianParams, camera: Camera, cfg: RenderConfig,
                             d_table: torch.Tensor) -> dict:
    """:func:`preprocess_backward_plain`'s gradients from one launch of the
    backward kernel (``csrc/preprocess.cu``). Raises ``ValueError`` on
    inputs it does not take: those :func:`check_inputs` refuses, and a
    ``d_table`` that is not a contiguous float32 [9, N] on their device."""
    check_inputs(params, camera)
    n = params.num_gaussians
    if (d_table.dtype != torch.float32 or tuple(d_table.shape) != (9, n)
            or not d_table.is_contiguous() or d_table.device != params.means.device):
        raise ValueError(f"preprocess backward kernel: d_table must be contiguous float32 "
                         f"[9, {n}] on {params.means.device}, got {d_table.dtype} "
                         f"{list(d_table.shape)} on {d_table.device}")
    grads = {k: torch.empty_like(getattr(params, k)) for k in GRAD_FIELDS}
    launch_backward(params, camera, cfg, d_table, grads)
    return grads


def launch_backward(params: GaussianParams, camera: Camera, cfg: RenderConfig,
                    d_table: torch.Tensor, grads: dict) -> None:
    """One C call of the backward kernel into ``grads`` (shaped as the
    parameters) on checked inputs, counted in ``BACKWARD_LAUNCHES``."""
    global BACKWARD_LAUNCHES
    ptrs = [t.data_ptr() for t in (*_tensors(params, GRAD_FIELDS),
                                   *_tensors(camera, CAMERA_SHAPES), d_table)]
    err = _backward_kernel()(
        *ptrs, params.num_gaussians, camera.width, camera.height, _degree(cfg),
        CLAMPED_CHANNELS[cfg.color_clamp], cfg.scale_modifier, cfg.z_near_cull, cfg.dilation,
        *(grads[k].data_ptr() for k in GRAD_FIELDS), _build.stream_ptr(d_table.device))
    _build.check(err, "preprocess backward kernel")
    BACKWARD_LAUNCHES += 1
