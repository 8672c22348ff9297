"""The plain reference: the 3DGS renderer's contract, its L1 + D-SSIM loss,
its gradients and Adam, in plain PyTorch.

Independent of the program: it imports neither ``jax``, the JAX package nor
the port, and takes only what the benchmark made (the scene, the cameras'
matrices, the targets). It follows the published renderer (3DGS.cpp's
shaders, which the port's docstrings cite) and no code of the port:

* projection (``preprocess.comp``): view-space cull at z <= ``z_near``, the
  Jacobian clamped at 1.3 tan(fov), the 2D covariance dilated by +0.3,
  cull at det <= 0, radius ``ceil(3 sqrt(lambda_max))`` with the eigenvalue
  floor, or its opacity-aware form (``tight_radius``: never smaller where
  alpha >= 1/255), the tile box of the radius, SH colour + 0.5 with only
  red clamped at 0;
* the blend (``render.comp``): per pixel of a tile, the Gaussians whose
  tile box covers it, in (depth, index) order; ``alpha = min(0.99, op
  exp(power))``, skipped where ``power > 0`` or ``alpha < 1/255``; a
  Gaussian adds colour while the transmittance after it stays >= 1e-4;
* the loss: ``(1 - w) L1 + w (1 - SSIM)``, SSIM with an 11-tap Gaussian
  window (sigma 1.5), zero padding, C1 = 0.01^2, C2 = 0.03^2;
* gradients by autograd of that blend; the blend is run in batches of
  tiles and recomputed batch by batch in the backward, so it fits at
  6M Gaussians and 1080p;
* Adam per parameter group (3DGS's learning rates, optax's order).

Everything runs in the dtype of the parameters it is given: float32 for
the reference, bfloat16 for the control (the configurations state float32).
TF32 is switched off while it runs.
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
TILE = 16
Z_NEAR, DILATION, ALPHA_MAX, ALPHA_MIN, T_MIN = 0.2, 0.3, 0.99, 1.0 / 255.0, 1e-4
PAIR_BUDGET = 1 << 24  # (instance, pixel) pairs a blend batch holds
FIELDS = ("means", "log_scales", "quats", "opacities", "sh")


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmuls and convolutions, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def camera(mats: dict, dtype, device) -> dict:
    """The matrices of a camera as tensors of ``dtype``."""
    t = {k: torch.tensor(mats[k], dtype=dtype, device=device)
         for k in ("view", "proj", "cam_pos")}
    return dict(t, tan_fovx=float(mats["tan_fovx"]), tan_fovy=float(mats["tan_fovy"]),
                width=mats["width"], height=mats["height"])


def _sh_basis(d):
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, SH_C0),
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * z * x,
        SH_C2[4] * (xx - yy),
        SH_C3[0] * (3 * xx - yy) * y, SH_C3[1] * x * y * z, SH_C3[2] * (4 * zz - xx - yy) * y,
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
        SH_C3[5] * (xx - yy) * z, SH_C3[6] * x * (xx - 3 * yy),
    ], dim=1)


def project(p: dict, cam: dict, sh_degree: int, tight_radius: bool) -> dict:
    """Screen-space attributes of every Gaussian: ``attr`` [N, 9] (u, v,
    conic a, b, c, opacity, r, g, b; differentiable), ``depth`` [N],
    ``box`` [N, 4] int64 tile box (x0, y0, x1, y1; x1, y1 exclusive) and
    ``visible`` [N] bool."""
    m = p["means"]
    w_img, h_img = cam["width"], cam["height"]
    tiles_x, tiles_y = -(-w_img // TILE), -(-h_img // TILE)
    view, proj = cam["view"], cam["proj"]
    x, y, z = m[:, 0], m[:, 1], m[:, 2]

    def row(mat, r):  # (mat @ [x, y, z, 1])[r], summed in the shader's order
        return mat[r, 0] * x + mat[r, 1] * y + mat[r, 2] * z + mat[r, 3]

    tx, ty, depth = row(view, 0), row(view, 1), row(view, 2)
    front = depth > Z_NEAR
    one = torch.ones_like(depth)
    inv_w = 1.0 / torch.where(front, row(proj, 3), one)
    ndc_x, ndc_y = row(proj, 0) * inv_w, row(proj, 1) * inv_w
    tz = torch.where(front, depth, one)
    limx, limy = 1.3 * cam["tan_fovx"], 1.3 * cam["tan_fovy"]
    txc = torch.clamp(tx / tz, -limx, limx) * tz
    tyc = torch.clamp(ty / tz, -limy, limy) * tz
    fx = w_img / (2.0 * cam["tan_fovx"])
    fy = h_img / (2.0 * cam["tan_fovy"])
    zero = torch.zeros_like(tz)
    jac = torch.stack([torch.stack([fx / tz, zero, -fx * txc / (tz * tz)], 1),
                       torch.stack([zero, fy / tz, -fy * tyc / (tz * tz)], 1)], 1)  # [N, 2, 3]
    mm = jac @ view[:3, :3]  # [N, 2, 3]

    q = p["quats"]
    q = q / torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rot = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)], 1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)], 1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)], 1),
    ], 1)  # [N, 3, 3]
    rs = rot * torch.exp(p["log_scales"])[:, None, :]
    cov3 = rs @ rs.transpose(1, 2)
    cov2 = mm @ cov3 @ mm.transpose(1, 2)
    a = cov2[:, 0, 0] + DILATION
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + DILATION
    det = a * c - b * b
    pos_det = det > 0
    inv_det = 1.0 / torch.where(pos_det, det, one)
    opacity = torch.sigmoid(p["opacities"])

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))
    if tight_radius:
        mult2 = 2.0 * torch.log(torch.clamp_min(255.0 * opacity, 1e-12))
        tight = torch.ceil(torch.sqrt(torch.clamp_min(lam, 0.0) * torch.clamp_min(mult2, 0.0)))
        radius = torch.where(255.0 * opacity < 1.0, zero, torch.minimum(radius, tight + 2.0))
    u = ((ndc_x + 1.0) * w_img - 1.0) * 0.5
    v = ((ndc_y + 1.0) * h_img - 1.0) * 0.5

    with torch.no_grad():
        r, ud, vd = radius.detach(), u.detach(), v.detach()
        box = torch.stack([
            torch.clamp(torch.floor((ud - r) / TILE), 0, tiles_x),
            torch.clamp(torch.floor((vd - r) / TILE), 0, tiles_y),
            torch.clamp(torch.floor((ud + r + TILE - 1) / TILE), 0, tiles_x),
            torch.clamp(torch.floor((vd + r + TILE - 1) / TILE), 0, tiles_y),
        ], 1).to(torch.int64)
        area = (box[:, 2] - box[:, 0]).clamp_min(0) * (box[:, 3] - box[:, 1]).clamp_min(0)
        visible = front & pos_det & p["alive"] & (area > 0) & (r > 0)

    d = m - cam["cam_pos"]
    d = d / torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
    k = (sh_degree + 1) ** 2
    rgb = torch.einsum("nk,nkc->nc", _sh_basis(d)[:, :k], p["sh"][:, :k]) + 0.5
    rgb = torch.cat([rgb[:, :1].clamp_min(0.0), rgb[:, 1:]], dim=1)
    attr = torch.cat([u[:, None], v[:, None], (c * inv_det)[:, None], (-b * inv_det)[:, None],
                      (a * inv_det)[:, None], opacity[:, None], rgb], dim=1)
    return dict(attr=attr, depth=depth.detach(), box=box, visible=visible)


def instance_count(pr: dict) -> int:
    """(tile, Gaussian) pairs of the visible Gaussians' tile boxes."""
    box = pr["box"][pr["visible"]]
    return int(((box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])).sum())


def bin_tiles(pr: dict, width: int, height: int) -> dict:
    """Each tile's Gaussians in (depth, index) order: ``gid`` [I] sorted by
    tile, then depth, then index; ``start``/``count`` [T]."""
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    dev = pr["depth"].device
    vis = torch.nonzero(pr["visible"]).squeeze(1)
    order = torch.sort(pr["depth"][vis].float(), stable=True).indices
    vis = vis[order]  # visible ids in (depth, index) order
    box = pr["box"][vis]
    bw = box[:, 2] - box[:, 0]
    counts = bw * (box[:, 3] - box[:, 1])
    owner = torch.repeat_interleave(torch.arange(vis.shape[0], device=dev), counts)
    local = torch.arange(owner.shape[0], device=dev) - (torch.cumsum(counts, 0) - counts)[owner]
    tile = (box[owner, 1] + local // bw[owner]) * tiles_x + box[owner, 0] + local % bw[owner]
    key = tile * vis.shape[0] + owner  # owner is the depth rank
    key, perm = torch.sort(key)
    num_tiles = tiles_x * tiles_y
    count = torch.bincount(tile, minlength=num_tiles)
    return dict(gid=vis[owner[perm]], start=torch.cumsum(count, 0) - count, count=count,
                tiles_x=tiles_x, tiles_y=tiles_y, visible=int(vis.shape[0]))


def _batches(count: torch.Tensor):
    """Tiles in batches of like length: (tile ids, longest count), each
    batch within ``PAIR_BUDGET`` (instance, pixel) pairs."""
    order = torch.argsort(count, descending=True)
    counts = count[order].tolist()
    i, n = 0, len(counts)
    while i < n and counts[i] > 0:
        k = counts[i]
        b = max(1, PAIR_BUDGET // (k * TILE * TILE))
        yield order[i:i + b], k
        i += b


def _blend(attr, valid, px, py):
    """attr [B, K, 9] in depth order, valid [B, K], pixel centres px, py
    [B, P]. Returns (rgb [B, P, 3], evaluated pairs, contributing pairs):
    a pair is evaluated where it passes the alpha test while the pixel is
    not yet saturated, and contributes where it also adds colour."""
    dx = attr[:, :, 0, None] - px[:, None, :]
    dy = attr[:, :, 1, None] - py[:, None, :]
    power = (-0.5 * (attr[:, :, 2, None] * dx * dx + attr[:, :, 4, None] * dy * dy)
             - attr[:, :, 3, None] * dx * dy)
    alpha = torch.clamp_max(attr[:, :, 5, None] * torch.exp(power), ALPHA_MAX)
    ok = valid[:, :, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    f = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
    t_incl = torch.cumprod(f, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    contrib = ok & (t_incl >= T_MIN)
    wgt = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
    rgb = torch.einsum("bkp,bkc->bpc", wgt, attr[:, :, 6:9])
    with torch.no_grad():
        evaluated = int((ok & (t_excl >= T_MIN)).sum())
        contributing = int(contrib.sum())
    return rgb, evaluated, contributing


def _batch_inputs(attr, bins, tiles, k):
    dev = attr.device
    ks = torch.arange(k, device=dev)
    idx = bins["start"][tiles][:, None] + ks[None, :]
    valid = ks[None, :] < bins["count"][tiles][:, None]
    gid = bins["gid"][torch.clamp_max(idx, bins["gid"].shape[0] - 1)]
    lin = torch.arange(TILE * TILE, device=dev)
    px = (tiles % bins["tiles_x"])[:, None] * TILE + lin % TILE
    py = (tiles // bins["tiles_x"])[:, None] * TILE + lin // TILE
    return gid, valid, px.to(attr.dtype), py.to(attr.dtype)


def _tiles_to_image(tiles, bins, width, height):
    tx, ty = bins["tiles_x"], bins["tiles_y"]
    img = tiles.reshape(ty, tx, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(ty * TILE, tx * TILE, 3)[:height, :width]


def render(attr: torch.Tensor, bins: dict, width: int, height: int):
    """The image [H, W, 3] (no autograd) and the work counts: evaluated
    and contributing pairs, visible Gaussians."""
    num_tiles = bins["count"].shape[0]
    out = torch.zeros((num_tiles, TILE * TILE, 3), dtype=attr.dtype, device=attr.device)
    ev = co = 0
    with torch.no_grad():
        for tiles, k in _batches(bins["count"]):
            gid, valid, px, py = _batch_inputs(attr, bins, tiles, k)
            rgb, e, c = _blend(attr[gid], valid, px, py)
            out[tiles] = rgb
            ev, co = ev + e, co + c
    counts = dict(evaluated=ev, contributing=co, visible=bins["visible"])
    return _tiles_to_image(out, bins, width, height), counts


def render_backward(attr: torch.Tensor, bins: dict, d_img: torch.Tensor) -> torch.Tensor:
    """d loss / d attr [N, 9] from d loss / d image, recomputing the blend
    batch by batch under autograd."""
    tx, ty = bins["tiles_x"], bins["tiles_y"]
    h, w = d_img.shape[:2]
    pad = torch.zeros((ty * TILE, tx * TILE, 3), dtype=d_img.dtype, device=d_img.device)
    pad[:h, :w] = d_img
    d_tiles = pad.reshape(ty, TILE, tx, TILE, 3).permute(0, 2, 1, 3, 4).reshape(-1, TILE * TILE, 3)
    a = attr.detach().requires_grad_(True)
    for tiles, k in _batches(bins["count"]):
        gid, valid, px, py = _batch_inputs(attr, bins, tiles, k)
        with torch.enable_grad():
            rgb, _, _ = _blend(a[gid], valid, px, py)
            rgb.backward(d_tiles[tiles])
    return a.grad if a.grad is not None else torch.zeros_like(attr)


# -- the loss --

def _gauss_taps(dtype, device, size=11, sigma=1.5):
    x = torch.arange(size, dtype=torch.float64) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    return (g / g.sum()).to(dtype=dtype, device=device)


def ssim_mean(img, target, size=11, sigma=1.5):
    """Mean SSIM of an [H, W, C] pair, full map (zero padding, SAME)."""
    c = img.shape[-1]
    g = _gauss_taps(img.dtype, img.device, size, sigma)
    gh = g.view(1, 1, 1, size).expand(c, 1, 1, size)
    gv = g.view(1, 1, size, 1).expand(c, 1, size, 1)

    def filt(x):  # [1, C, H, W], separable: rows then columns
        x = F.conv2d(x, gh, padding=(0, size // 2), groups=c)
        return F.conv2d(x, gv, padding=(size // 2, 0), groups=c)

    x = img.permute(2, 0, 1)[None]
    y = target.permute(2, 0, 1)[None]
    mx, my = filt(x), filt(y)
    sxx = filt(x * x) - mx * mx
    syy = filt(y * y) - my * my
    sxy = filt(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    smap = ((2 * mx * my + c1) * (2 * sxy + c2)) / ((mx * mx + my * my + c1) * (sxx + syy + c2))
    return smap.mean()


def loss(img, target, ssim_weight):
    """(1 - w) L1 + w (1 - SSIM)."""
    return (1.0 - ssim_weight) * (img - target).abs().mean() + ssim_weight * (
        1.0 - ssim_mean(img, target))


# -- one training step --

# 3DGS's learning rates (graphdeco-inria/gaussian-splatting,
# arguments/__init__.py): position 1.6e-4 -> 1.6e-6 times the scene extent
# over 30k steps, scaling 5e-3, rotation 1e-3, opacity 5e-2, features 2.5e-3.
LR = dict(means=1.6e-4, means_final=1.6e-6, means_steps=30_000, log_scales=5e-3, quats=1e-3,
          opacities=5e-2, sh=2.5e-3)


def learning_rates(extent: float, count: int) -> dict:
    """The learning rate of each group at an update count: the means' decays
    exponentially from ``1.6e-4 * extent`` to ``1.6e-6 * extent``."""
    init, end = LR["means"] * extent, LR["means_final"] * extent
    rate = LR["means_final"] / LR["means"]
    means = init if count <= 0 else max(end, init * rate ** (count / LR["means_steps"]))
    return dict({k: LR[k] for k in FIELDS[1:]}, means=means)


def adam(p: dict, g: dict, state: dict, extent: float) -> dict:
    """One Adam step (b1 0.9, b2 0.999, eps 1e-15) of the parameters
    ``FIELDS``; ``state`` holds ``m``, ``v`` and ``count``, updated."""
    b1, b2, eps = 0.9, 0.999, 1e-15
    count = state["count"]
    lr = learning_rates(extent, count)
    c = torch.tensor(float(count + 1), dtype=torch.float32)
    bc1, bc2 = float(1 - torch.pow(b1, c)), float(1 - torch.pow(b2, c))
    out = dict(p)
    for k in FIELDS:
        m = (1 - b1) * g[k] + b1 * state["m"][k]
        v = (1 - b2) * (g[k] * g[k]) + b2 * state["v"][k]
        out[k] = p[k] - lr[k] * ((m / bc1) / (torch.sqrt(v / bc2) + eps))
        state["m"][k], state["v"][k] = m, v
    state["count"] = count + 1
    return out


FAULTS = ("half_batch", "altered", "strip_lost", "halo_cut")


def faults_for(conf: dict) -> tuple:
    """The faults a configuration's step can have: the strip faults only
    where its image is split into strips (a ``mesh`` of ``tile`` > 1)."""
    return FAULTS if strips_of(conf) > 1 else FAULTS[:2]


def strips_of(conf: dict) -> int:
    return int(conf.get("mesh", {}).get("tile", 1))


def strip_rows(conf: dict, height: int) -> int:
    """Tile rows of one strip: the image's tile rows over the strips,
    rounded up (the last strip may reach past the image)."""
    tiles_y = -(-height // TILE)
    return -(-tiles_y // strips_of(conf))


def train_step(p: dict, cam: dict, target: torch.Tensor, conf: dict, ssim_weight: float,
               fault: str | None = None):
    """Loss and gradients of one view. Returns (loss, grads, work counts as
    :func:`render` gives them). ``fault`` plants one of ``FAULTS``, to read what
    the comparison makes of it: ``half_batch`` takes the loss over the left
    half of the image alone, ``altered`` adds 0.1 to the 64x64 pixels of
    the image's first 4x4 tiles; of a configuration split into strips,
    ``strip_lost`` detaches the second strip's rows from the loss (its
    value unchanged, its gradient lost, as a lost strip or bucket leaves
    it) and ``halo_cut`` takes SSIM strip by strip, each zero-padded at
    its edges (as a missing halo exchange gives)."""
    leaves = {k: p[k].detach().requires_grad_(True) for k in FIELDS}
    pr = project(dict(leaves, alive=p["alive"]), cam, conf["sh_degree"], conf["tight_radius"])
    bins = bin_tiles(pr, cam["width"], cam["height"])
    attr = pr["attr"]
    img, pairs = render(attr.detach(), bins, cam["width"], cam["height"])
    img = img.requires_grad_(True)
    strip = strip_rows(conf, cam["height"]) * TILE
    with torch.enable_grad():
        shown, tgt = img, target
        if fault == "half_batch":
            half = cam["width"] // 2
            shown, tgt = img[:, :half], target[:, :half]
        elif fault == "altered":
            b = 4 * TILE
            shown = img + F.pad(torch.full((b, b, 3), 0.1, dtype=img.dtype, device=img.device),
                                (0, 0, 0, img.shape[1] - b, 0, img.shape[0] - b))
        elif fault == "strip_lost":
            shown = torch.cat([img[:strip], img[strip:2 * strip].detach(), img[2 * strip:]])
        elif fault not in (None, "halo_cut"):
            raise ValueError(f"unknown fault {fault!r}")
        if fault == "halo_cut":
            ssim = sum(ssim_mean(img[a:a + strip], target[a:a + strip])
                       * (min(a + strip, img.shape[0]) - a)
                       for a in range(0, img.shape[0], strip)) / img.shape[0]
            value = (1.0 - ssim_weight) * (img - target).abs().mean() + ssim_weight * (
                1.0 - ssim)
        else:
            value = loss(shown, tgt, ssim_weight)
        (d_img,) = torch.autograd.grad(value, img)
    d_attr = render_backward(attr, bins, d_img)
    grads = torch.autograd.grad(attr, [leaves[k] for k in FIELDS], d_attr, allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if gr is None else gr)
             for k, gr in zip(FIELDS, grads)}
    return float(value.detach()), grads, pairs


def adam_state(p: dict) -> dict:
    return dict(m={k: torch.zeros_like(p[k]) for k in FIELDS},
                v={k: torch.zeros_like(p[k]) for k in FIELDS}, count=0)


def frame(p: dict, cam: dict, conf: dict):
    """The image [H, W, 3] of one camera and its work counts."""
    with torch.no_grad():
        pr = project(p, cam, conf["sh_degree"], conf["tight_radius"])
        bins = bin_tiles(pr, cam["width"], cam["height"])
        return render(pr["attr"], bins, cam["width"], cam["height"])


def cast(p: dict, dtype) -> dict:
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in p.items()}


def instances_needed(p: dict, cams: list, conf: dict) -> int:
    """The largest instance count over ``cams`` (the capacity probe)."""
    with torch.no_grad():
        return max(instance_count(project(p, camera(c, p["means"].dtype, p["means"].device),
                                          conf["sh_degree"], conf["tight_radius"]))
                   for c in cams)


def strip_instances_needed(p: dict, cams: list, conf: dict) -> int:
    """The largest instance count of one strip over ``cams``: each visible
    Gaussian's tile box cut to the strip's tile rows (the capacity probe of
    a tile-sharded step, whose instance buffers hold one strip)."""
    rows = strip_rows(conf, cams[0]["height"])
    best = 0
    with torch.no_grad():
        for c in cams:
            pr = project(p, camera(c, p["means"].dtype, p["means"].device), conf["sh_degree"],
                         conf["tight_radius"])
            box = pr["box"][pr["visible"]]
            width = box[:, 2] - box[:, 0]
            for k in range(strips_of(conf)):
                top = torch.clamp(box[:, 1], min=k * rows)
                bottom = torch.clamp(box[:, 3], max=(k + 1) * rows)
                best = max(best, int((width * (bottom - top).clamp_min(0)).sum()))
    return best


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))

