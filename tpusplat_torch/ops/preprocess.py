"""Per-Gaussian preprocessing: 3D covariance, EWA projection, SH color
(counterpart of ``tpusplat/ops/preprocess.py``).

One elementwise float32 pass over all N Gaussians. The JAX package computes
it outside Pallas, so there is no TPU kernel to port here; the port adds
one, ``csrc/preprocess.cu``, for the frames that need no gradient.
:func:`preprocess` routes by what it can observe in its input:

  * a CUDA call that autograd will record (gradients enabled and some
    parameter or camera tensor requiring grad: the train steps and the
    sharded steps) runs :func:`preprocess_plain`, the plain PyTorch version,
    differentiable by autograd;
  * every other CUDA call (``Session.draw``, ``render``, ``render_auto``,
    the trainer's evals, the viewers) launches the kernel through
    :func:`preprocess_cuda`, or raises on what it does not take;
  * a CPU call runs :func:`preprocess_plain`.

Both give the same outputs, the culls, radius, aabb and ntiles bit for bit
on the card. Every reference quirk is kept:
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

import torch

from tpusplat_torch.config import SH_C0, SH_C1, SH_C2, SH_C3, RenderConfig
from tpusplat_torch.ops import _build
from tpusplat_torch.ops.activations import activate_opacity, activate_scales, normalize_quat
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


def compute_cov3d(log_scales: torch.Tensor, quats: torch.Tensor, modifier: float = 1.0):
    """Sigma_3D = R S^2 R^T as its upper triangle (xx, xy, xz, yy, yz, zz)
    (``precomp_cov3d.comp:31-47``)."""
    s = activate_scales(log_scales, modifier)
    q = normalize_quat(quats)
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = quat_to_rotmat_cols(q)
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    xx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    xy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    xz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    yy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    yz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    zz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return xx, xy, xz, yy, yz, zz


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


def eval_sh(means, sh, cam_pos, degree: int, clamp: str):
    """View-dependent color from SH (``preprocess.comp:72-108``)."""
    d = means - cam_pos
    d = d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True))
    basis = _sh_basis(d[..., 0], d[..., 1], d[..., 2], degree)  # [N, K]
    k = basis.shape[-1]
    c = torch.sum(basis[..., None] * sh[..., :k, :], dim=-2) + 0.5
    if clamp == "red":
        # Reference quirk: only c.x clamped (preprocess.comp:102-104).
        c = torch.cat([c[..., :1].clamp_min(0.0), c[..., 1:]], dim=-1)
    elif clamp == "all":
        c = c.clamp_min(0.0)
    return c


def preprocess_plain(params: GaussianParams, camera: Camera,
                     cfg: RenderConfig) -> ProcessedGaussians:
    """Project all Gaussians for one camera, in plain PyTorch.
    Differentiable by autograd."""
    f32 = torch.float32
    means = params.means.to(f32)

    view = camera.view
    proj = camera.proj
    w_img, h_img = camera.width, camera.height
    tiles_x, tiles_y = cfg.tile_grid(w_img, h_img)

    # --- view/clip transforms (preprocess.comp:129-137) ---
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    p_view = [view[r, 0] * mx + view[r, 1] * my + view[r, 2] * mz + view[r, 3] for r in range(3)]
    depth = p_view[2]
    visible = depth > cfg.z_near_cull

    p_hom_w = proj[3, 0] * mx + proj[3, 1] * my + proj[3, 2] * mz + proj[3, 3]
    # Guarded so culled lanes stay finite (the reference divides and culls).
    one = torch.ones_like(p_hom_w)
    p_w = 1.0 / torch.where(visible, p_hom_w, one)
    ndc_x = (proj[0, 0] * mx + proj[0, 1] * my + proj[0, 2] * mz + proj[0, 3]) * p_w
    ndc_y = (proj[1, 0] * mx + proj[1, 1] * my + proj[1, 2] * mz + proj[1, 3]) * p_w

    tz = torch.where(visible, depth, one)
    tx, ty = p_view[0], p_view[1]

    # --- EWA 2D covariance (preprocess.comp:34-66) ---
    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    txc = torch.clamp(tx / tz, -limx, limx) * tz
    tyc = torch.clamp(ty / tz, -limy, limy) * tz
    focal_x = w_img / (2.0 * camera.tan_fovx)
    focal_y = h_img / (2.0 * camera.tan_fovy)

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * txc * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * tyc * inv_z2

    # M = J @ V3 (2x3), V3 = upper-left of the (flipped) view matrix.
    v = view
    m00 = j00 * v[0, 0] + j02 * v[2, 0]
    m01 = j00 * v[0, 1] + j02 * v[2, 1]
    m02 = j00 * v[0, 2] + j02 * v[2, 2]
    m10 = j11 * v[1, 0] + j12 * v[2, 0]
    m11 = j11 * v[1, 1] + j12 * v[2, 1]
    m12 = j11 * v[1, 2] + j12 * v[2, 2]

    xx, xy, xz, yy, yz, zz = compute_cov3d(
        params.log_scales.to(f32), params.quats.to(f32), cfg.scale_modifier
    )

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
    visible = visible & (det > 0.0)
    det_safe = torch.where(det > 0.0, det, one)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c_c * inv_det, -c_b * inv_det, c_a * inv_det], dim=-1)

    # --- radius from max eigenvalue (preprocess.comp:148-152) ---
    mid = 0.5 * (c_a + c_c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam = mid + disc
    opacity = activate_opacity(params.opacities.to(f32))
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
    uv_x = ((ndc_x + 1.0) * w_img - 1.0) * 0.5
    uv_y = ((ndc_y + 1.0) * h_img - 1.0) * 0.5
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

    color = eval_sh(means, params.sh.to(f32), camera.cam_pos, cfg.sh_degree, cfg.color_clamp)

    return ProcessedGaussians(
        uv=uv,
        conic=conic,
        opacity=opacity,
        color=color,
        depth=depth,
        aabb=torch.stack([x0, y0, x1, y1], dim=-1),
        ntiles=ntiles,
        radius=radius,
    )


# C calls of the kernel since the last reset (chip_smoke.py reads it).
LAUNCHES = 0
CLAMP_MODES = {"red": 0, "all": 1, "none": 2}
# Trailing shapes of the inputs (float32, alive bool), and which of them the
# kernel reads with 16-byte loads.
PARAM_SHAPES = dict(means=(3,), log_scales=(3,), quats=(4,), opacities=(), sh=(16, 3),
                    alive=())
CAMERA_SHAPES = dict(view=(4, 4), proj=(4, 4), cam_pos=(3,), tan_fovx=(), tan_fovy=())
ALIGNED = ("quats", "sh")
# Words a Gaussian of the kernel's output buffer, field by field: aabb [N, 4]
# int32, the blend's [9, N] attribute table (uv, conic, opacity and color as
# rows), depth, radius, ntiles (int32).
OUT_WORDS = 16


def preprocess(params: GaussianParams, camera: Camera, cfg: RenderConfig) -> ProcessedGaussians:
    """Project all Gaussians for one camera: through :func:`preprocess_plain`
    on the CPU and where autograd records the call (so gradients reach the
    parameters and the camera), else through the kernel
    (:func:`preprocess_cuda`)."""
    if params.device.type == "cpu" or _records_grad(params, camera):
        return preprocess_plain(params, camera, cfg)
    return preprocess_cuda(params, camera, cfg)


def _records_grad(params: GaussianParams, camera: Camera) -> bool:
    """Whether autograd would record a call on these inputs."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (*_tensors(params, PARAM_SHAPES),
                                  *_tensors(camera, CAMERA_SHAPES)))


def _tensors(obj, shapes: dict) -> list:
    return [getattr(obj, name) for name in shapes]


def _kernel():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("preprocess", "tpusplat_preprocess",
                           [p] * 11 + [i] * 10 + [f] * 3 + [p, p])


def check_inputs(params: GaussianParams, camera: Camera) -> None:
    """Raise ``ValueError`` unless the inputs are what the kernel takes:
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
        tiles_x, tiles_y, min(max(cfg.sh_degree, 0), 3),  # the degrees the plain basis has
        CLAMP_MODES[cfg.color_clamp], int(cfg.tight_radius),
        cfg.scale_modifier, cfg.z_near_cull, cfg.dilation, out.data_ptr(),
        _build.stream_ptr(out.device))
    _build.check(err, "preprocess kernel")
    LAUNCHES += 1


def output_fields(out: torch.Tensor, n: int) -> ProcessedGaussians:
    """The kernel's output buffer as :class:`ProcessedGaussians`, each field
    a view of it: uv, conic, opacity and color are row views of the [9, N]
    table (uv and conic and color transposed, so not contiguous), the rest
    contiguous."""
    ints = out.view(torch.int32)
    table = out[4 * n:13 * n].view(9, n)
    return ProcessedGaussians(
        aabb=ints[:4 * n].view(n, 4),
        uv=table[0:2].T,
        conic=table[2:5].T,
        opacity=table[5],
        color=table[6:9].T,
        depth=out[13 * n:14 * n],
        radius=out[14 * n:15 * n],
        ntiles=ints[15 * n:16 * n],
    )


def attribute_table(pg: ProcessedGaussians) -> torch.Tensor:
    """[9, N]: uv, conic, opacity and color as rows, the table the blend
    gathers from. Where the four fields are views of the rows of one such
    table, as the kernel's are (:func:`output_fields`), that table is
    returned as it lies; otherwise the fields are concatenated into a new
    one (the plain version's, autograd's graph included)."""
    rows = (pg.uv.T, pg.conic.T, pg.opacity[None, :], pg.color.T)
    n, first = pg.opacity.shape[0], rows[0]
    lies = all(r.is_contiguous() and r.untyped_storage().data_ptr()
               == first.untyped_storage().data_ptr()
               and r.data_ptr() == first.data_ptr() + k * n * first.element_size()
               for r, k in zip(rows, (0, 2, 5, 6)))
    return first.as_strided((9, n), (n, 1)) if lies else torch.cat(rows, dim=0)
