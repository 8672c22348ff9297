"""Tile rasterization: attribute gather, forward blend and their gradients.

Counterpart of two JAX modules: ``tpusplat/ops/rasterize_pallas.py``
(``pack_instances`` with ``_pack_gather``, ``_raster_core`` with the
forward and backward kernels, ``_assemble_strip``) and
``tpusplat/ops/rasterize_xla.py`` (the chunked-cumprod blend, which is the
plain version here).

  * :func:`pack_instances` gathers the per-instance attributes into a
    [9, C] float32 slab (rows: uv.x, uv.y, conic a/b/c, opacity, r/g/b;
    dead slots, whose gid is N, read Gaussian N-1 and lie outside every
    tile range). The JAX slab's 7 pad rows and WIN pad columns were for TPU
    tiling and DMA windows and are dropped. Its backward
    (:func:`gather_grad`) is the JAX ``_pack_gather_bwd``: a stable sort of
    the gradient rows by the raw gid, ``searchsorted`` for each Gaussian's
    run, and the segment reduce of :mod:`tpusplat_torch.ops.segment_reduce`,
    which drops the sentinel ids (their rows hold stale memory on the card).
  * :func:`forward_blend` and :func:`backward_blend` route by device: a CPU
    tensor goes through :func:`blend_plain` and :func:`backward_blend_plain`
    (autograd of the plain blend), a CUDA tensor through
    ``csrc/rasterize_forward.cu`` and ``csrc/rasterize_backward.cu`` (or the
    call raises). ``_RasterCore`` joins them for autograd on both devices.

The blend: per pixel, front to back, ``alpha = min(0.99, op exp(power))``;
instances with ``power > 0`` or ``alpha < 1/255`` are skipped; an instance
adds colour only while the inclusive transmittance stays >= 1e-4, and the
final T multiplies every passing instance (``render.comp:68-88``).
"""

from __future__ import annotations

import ctypes

import torch

from tpusplat_torch import trace
from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops import _build
from tpusplat_torch.ops.binning import BinnedInstances
from tpusplat_torch.ops.preprocess import ProcessedGaussians, attribute_table
from tpusplat_torch.ops.segment_reduce import segment_reduce

ATTR_ROWS = 9
A_UVX, A_UVY, A_CA, A_CB, A_CC, A_OP, A_CR, A_CG, A_CB_ = range(ATTR_ROWS)

# Kernel launches since the last reset (chip_smoke.py reads them).
FORWARD_LAUNCHES = 0
BACKWARD_LAUNCHES = 0


def _forward_kernel():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("rasterize_forward", "tpusplat_forward",
                           [p, ctypes.c_longlong, p, p, i, i, i, i, i, i, i, f, f, f, p, p, p])


def _backward_kernel():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("rasterize_backward", "tpusplat_backward",
                           [p, ctypes.c_longlong, p, p, i, i, i, i, i, i, i, f, f, f,
                            p, p, p, p, p, p])


def pack_instances(pg: ProcessedGaussians, binned: BinnedInstances) -> torch.Tensor:
    """The [9, C] attribute slab of the sorted instances (differentiable).
    The backward stamps ``preprocess_bwd`` once the table's gradient is
    reduced (:func:`tpusplat_torch.trace.grad_stage`)."""
    table = attribute_table(pg)  # [9, N]
    return _PackGather.apply(trace.grad_stage(table, "preprocess_bwd"), binned.gauss_id)


class _PackGather(torch.autograd.Function):
    """attr [K, C] = table [K, N] at the clamped gid; the backward reduces
    by the raw gid (``_pack_gather`` of rasterize_pallas.py). K is 9, or 18
    for the surfels' table (``ops/surfel.py``)."""

    @staticmethod
    def forward(ctx, table, gauss_id):
        n = table.shape[1]
        ctx.save_for_backward(gauss_id)
        ctx.n = n
        return table.index_select(1, torch.clamp_max(gauss_id, n - 1))

    @staticmethod
    def backward(ctx, d_attr):
        (gauss_id,) = ctx.saved_tensors
        return gather_grad(d_attr, gauss_id, ctx.n), None


def sort_grad_rows(rows: torch.Tensor, gauss_id: torch.Tensor, n: int):
    """Re-sort the gradient rows [K, C] by the raw gid (stable): returns
    (rows [K, C], sorted gid [C], bounds [N + 1]), where
    ``[bounds[g], bounds[g+1])`` is Gaussian g's run -- the inputs of the
    segment reduce (``_sort_grad_rows`` of rasterize_pallas.py)."""
    gid_s, perm = torch.sort(gauss_id, stable=True)
    ids = torch.arange(n + 1, dtype=gid_s.dtype, device=gid_s.device)
    return (rows.index_select(1, perm), gid_s,
            torch.searchsorted(gid_s, ids, out_int32=True))


def gather_grad(d_attr: torch.Tensor, gauss_id: torch.Tensor, n: int) -> torch.Tensor:
    """The transpose of the gather: d_attr [K, C] -> d_table [K, N].

    A segment reduction keyed on the raw gid, never autograd's
    ``index_select`` backward on the clamped gid, which would add every dead
    slot's row (gid N, stale memory on the card) to Gaussian N-1."""
    return segment_reduce(*sort_grad_rows(d_attr, gauss_id, n))


def _assemble_strip(rgb_tiles, t_tiles, nrows, tiles_x, tw, th, crop_h, width):
    """Per-tile pixels [T, P, 3] / [T, P] -> (img [crop_h, width, 3],
    tmap [crop_h, width]) (``_assemble_strip`` of rasterize_pallas.py)."""
    img = rgb_tiles.reshape(nrows, tiles_x, th, tw, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(nrows * th, tiles_x * tw, 3)
    tmap = t_tiles.reshape(nrows, tiles_x, th, tw)
    tmap = tmap.permute(0, 2, 1, 3).reshape(nrows * th, tiles_x * tw)
    return img[:crop_h, :width], tmap[:crop_h, :width]


def _blend_tiles_chunked(a, valid, px, py, cfg: RenderConfig):
    """Blend K depth-ordered instances into P pixels for B tiles at once.

    a: [9, B, K] attributes; valid: [B, K]; px, py: [B, P] pixel centres.
    Returns (rgb [B, P, 3], T_final [B, P]). Chunks of ``gauss_chunk``
    instances: within a chunk the transmittance is a cumulative product.
    """
    b, k = valid.shape
    p = px.shape[1]
    c_acc = torch.zeros((b, p, 3), dtype=a.dtype, device=a.device)
    t_acc = torch.ones((b, p), dtype=a.dtype, device=a.device)
    pxc, pyc = px[:, None, :], py[:, None, :]
    for k0 in range(0, k, cfg.gauss_chunk):
        ch = a[:, :, k0:k0 + cfg.gauss_chunk, None]  # [9, B, ck, 1]
        dx = ch[A_UVX] - pxc  # [B, ck, P]
        dy = ch[A_UVY] - pyc
        power = -0.5 * (ch[A_CA] * dx * dx + ch[A_CC] * dy * dy) - ch[A_CB] * dx * dy
        alpha = torch.clamp_max(ch[A_OP] * torch.exp(power), cfg.alpha_max)
        ok = valid[:, k0:k0 + cfg.gauss_chunk, None] & (power <= 0.0) & (alpha >= cfg.alpha_min)
        f = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
        t_incl = t_acc[:, None, :] * torch.cumprod(f, dim=1)
        t_excl = t_incl / f
        contrib = ok & (t_incl >= cfg.t_min)
        w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
        col = a[A_CR:, :, k0:k0 + cfg.gauss_chunk].permute(1, 2, 0)  # [B, ck, 3]
        c_acc = c_acc + torch.einsum("bkp,bkc->bpc", w, col)
        t_acc = t_incl[:, -1, :]
    return c_acc, t_acc


def blend_plain(attr, starts, ends, tiles_x: int, row0: int, width: int, crop_h: int,
                cfg: RenderConfig):
    """Plain PyTorch forward blend (the port of ``rasterize_xla``; the
    plain version of the CUDA kernel), on any device and differentiable.

    Each tile considers at most ``cfg.max_per_tile`` instances; the excess
    is returned as ``tile_overflow``. Returns (img [crop_h, width, 3],
    tmap [crop_h, width], tile_overflow)."""
    num_tiles = starts.shape[0]
    nrows = num_tiles // tiles_x
    tw, th = cfg.tile_w, cfg.tile_h
    npx = tw * th
    kcap = cfg.max_per_tile
    cap = attr.shape[1]
    dev = attr.device

    counts = (ends - starts).long()
    tile_overflow = torch.clamp_min(counts - kcap, 0).sum().to(torch.int32)
    counts = torch.clamp_max(counts, kcap)

    lin = torch.arange(npx, device=dev)
    ly = (lin // tw).to(attr.dtype)
    lx = (lin % tw).to(attr.dtype)

    tb = cfg.tile_chunk
    # The longest range of each tile batch, read once: the plain version
    # walks only as far as the batch needs.
    batch_k = torch.nn.functional.pad(counts, (0, -num_tiles % tb)).reshape(-1, tb)
    batch_k = batch_k.max(dim=1).values.tolist()
    rgb_parts, t_parts = [], []
    for bi, k in enumerate(batch_k):
        tiles = torch.arange(bi * tb, min((bi + 1) * tb, num_tiles), device=dev)
        if k == 0:
            rgb_parts.append(torch.zeros((len(tiles), npx, 3), dtype=attr.dtype, device=dev))
            t_parts.append(torch.ones((len(tiles), npx), dtype=attr.dtype, device=dev))
            continue
        ks = torch.arange(k, device=dev)
        idx = torch.clamp_max(starts[tiles].long()[:, None] + ks[None, :], cap - 1)
        valid = ks[None, :] < counts[tiles][:, None]
        a = attr[:, idx]  # [9, B, K]
        tx = (tiles % tiles_x).to(attr.dtype)
        ty = (row0 + tiles // tiles_x).to(attr.dtype)
        px = tx[:, None] * tw + lx[None, :]
        py = ty[:, None] * th + ly[None, :]
        rgb, t_fin = _blend_tiles_chunked(a, valid, px, py, cfg)
        rgb_parts.append(rgb)
        t_parts.append(t_fin)
    img, tmap = _assemble_strip(torch.cat(rgb_parts), torch.cat(t_parts), nrows, tiles_x,
                                tw, th, crop_h, width)
    return img, tmap, tile_overflow


def forward_blend(attr, starts, ends, tiles_x: int, row0: int, width: int, crop_h: int,
                  cfg: RenderConfig):
    """Forward blend of the [9, C] slab over the tile ranges ``starts``/
    ``ends`` ([T] int32, T = tiles_x * nrows). Returns (img, tmap,
    tile_overflow); the kernel walks the true ranges, so its tile_overflow
    is 0."""
    if attr.device.type == "cpu":
        return blend_plain(attr, starts, ends, tiles_x, row0, width, crop_h, cfg)
    return _forward_cuda(attr, starts, ends, tiles_x, row0, width, crop_h, cfg)


def _check_blend_args(what, attr, starts, ends, tiles_x, width, crop_h, cfg):
    """The CUDA blend kernels' contract; raises on what they do not take."""
    num_tiles = starts.shape[0]
    npx = cfg.tile_w * cfg.tile_h
    if attr.dtype != torch.float32 or attr.dim() != 2 or attr.shape[0] != ATTR_ROWS \
            or not attr.is_contiguous():
        raise ValueError(f"{what}: attr must be contiguous float32 [{ATTR_ROWS}, C], "
                         f"got {attr.dtype} {tuple(attr.shape)}")
    for name, t in dict(starts=starts, ends=ends).items():
        if t.device != attr.device or t.dtype != torch.int32 or t.shape != (num_tiles,) \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int32 [{num_tiles}] "
                             f"on {attr.device}")
    if num_tiles == 0 or num_tiles % tiles_x or not 0 < npx <= 1024 or npx % 32:
        raise ValueError(f"{what}: {num_tiles} tiles, tiles_x {tiles_x}, "
                         f"{npx} pixels a tile (a multiple of 32 up to 1024)")
    if crop_h > (num_tiles // tiles_x) * cfg.tile_h or width > tiles_x * cfg.tile_w:
        raise ValueError(f"{what}: the tiles do not cover the output")


def _forward_cuda(attr, starts, ends, tiles_x, row0, width, crop_h, cfg):
    global FORWARD_LAUNCHES
    _check_blend_args("forward_blend", attr, starts, ends, tiles_x, width, crop_h, cfg)
    img = torch.empty((crop_h, width, 3), dtype=torch.float32, device=attr.device)
    tmap = torch.empty((crop_h, width), dtype=torch.float32, device=attr.device)
    err = _forward_kernel()(
        attr.data_ptr(), attr.stride(0), starts.data_ptr(), ends.data_ptr(), starts.shape[0],
        tiles_x, cfg.tile_w, cfg.tile_h, int(row0), width, crop_h, cfg.alpha_max,
        cfg.alpha_min, cfg.t_min, img.data_ptr(), tmap.data_ptr(),
        _build.stream_ptr(attr.device))
    _build.check(err, "forward blend kernel")
    FORWARD_LAUNCHES += 1
    return img, tmap, torch.zeros((), dtype=torch.int32, device=attr.device)


def backward_blend_plain(attr, starts, ends, img, tmap, d_img, d_tmap, tiles_x: int,
                         row0: int, width: int, crop_h: int, cfg: RenderConfig):
    """Plain version of the backward kernel, on any device: autograd of
    :func:`blend_plain`, which recomputes the walk (``img`` and ``tmap``
    are not read). Returns d_attr [9, C], zero outside the tile ranges and
    past ``cfg.max_per_tile`` instances of a tile."""
    with torch.enable_grad():
        a = attr.detach().requires_grad_(True)
        img_r, tmap_r, _ = blend_plain(a, starts, ends, tiles_x, row0, width, crop_h, cfg)
        if not img_r.requires_grad:  # no instance in the window (an empty strip)
            return torch.zeros_like(attr)
        (d_attr,) = torch.autograd.grad((img_r, tmap_r), (a,), (d_img, d_tmap))
    return d_attr


# The blend kernels' cull (csrc/cull.cuh's note): slack on
# tau = ln(op / alpha_min), bound on float32's relative error in power,
# relative margin of a half-extent (added to one pixel).
CULL_TAU_SLACK, CULL_POWER_ERR, CULL_REL_MARGIN = 1e-5, 1e-6, 1e-3


def pass_extent_plain(conic: torch.Tensor, opacity: torch.Tensor, alpha_min: float):
    """Half-extents [N, 2] float32 (|dx|, |dy|) of the pixel offsets
    ``uv - pixel`` at which each instance can pass the blend's test
    (``op exp(power) >= alpha_min``, ``power <= 0``), margin included: the
    formula by which the forward and backward kernels cull (instance, warp)
    pairs (``csrc/cull.cuh``).
    +inf where the cull is off (an input not finite, ``alpha_min <= 0``, a
    conic that is not positive definite or too near singular for float32),
    -inf where no pixel passes. ``conic`` [N, 3] (a, b, c), ``opacity`` [N].
    Only tests and ``chip_smoke.py`` call it."""
    am = torch.tensor(alpha_min, dtype=torch.float32).item()  # the kernel takes float32
    a, b, c = (conic[:, i].double() for i in range(3))
    op = opacity.double()
    det = a * c - b * b
    tau = torch.log(op / am)
    rho = b.abs() / torch.sqrt(a * c)
    kappa = (1 + rho) / (1 - rho)
    q = 2 * (tau.clamp_min(0) + CULL_TAU_SLACK) / (1 - CULL_POWER_ERR * kappa)
    h = torch.stack([torch.sqrt(q * c / det), torch.sqrt(q * a / det)], dim=-1)
    h = h * (1 + CULL_REL_MARGIN) + 1
    inf = torch.tensor(float("inf"), dtype=h.dtype, device=h.device)
    # The kernel's tests, last to first, so the first that holds decides.
    for cond, val in ((CULL_POWER_ERR * kappa > 0.5, inf), (tau < -CULL_TAU_SLACK, -inf),
                      (~((a > 0) & (c > 0) & (det > 0)), inf), (op <= 0, -inf),
                      (~(torch.isfinite(conic).all(-1) & torch.isfinite(opacity))
                       | (am <= 0), inf)):
        h = torch.where(cond[:, None], val, h)
    return h.float()


def warp_pixels(tile_w: int, tile_h: int) -> torch.Tensor:
    """[P / 32, 32] int64: the pixels (``y * tile_w + x`` in the tile) of
    each warp of the forward and backward kernels, lane by lane (the
    layout of ``csrc/cull.cuh``): 8 x 4 blocks where the
    tile divides into them, else 32 consecutive pixels. Only tests and
    ``chip_smoke.py`` call it."""
    npx = tile_w * tile_h
    if tile_w % 8 or tile_h % 4:
        return torch.arange(npx).reshape(-1, 32)
    warp, lane = torch.arange(npx // 32)[:, None], torch.arange(32)[None, :]
    x = warp % (tile_w // 8) * 8 + lane % 8
    y = warp // (tile_w // 8) * 4 + lane // 8
    return y * tile_w + x


def backward_blend(attr, starts, ends, img, tmap, d_img, d_tmap, tiles_x: int, row0: int,
                   width: int, crop_h: int, cfg: RenderConfig):
    """Gradient of the forward blend: d_attr [9, C] from the slab, the tile
    ranges, the forward's outputs ``img`` [crop_h, width, 3] and ``tmap``
    [crop_h, width], and their cotangents ``d_img``/``d_tmap`` (same
    shapes). The kernel writes only the rows inside the tile ranges; the
    rest of its output is uninitialised (the gather's backward drops it)."""
    if attr.device.type == "cpu":
        return backward_blend_plain(attr, starts, ends, img, tmap, d_img, d_tmap, tiles_x,
                                    row0, width, crop_h, cfg)
    return _backward_cuda(attr, starts, ends, img, tmap, d_img, d_tmap, tiles_x, row0,
                          width, crop_h, cfg)


def _backward_cuda(attr, starts, ends, img, tmap, d_img, d_tmap, tiles_x, row0, width,
                   crop_h, cfg):
    global BACKWARD_LAUNCHES
    _check_blend_args("backward_blend", attr, starts, ends, tiles_x, width, crop_h, cfg)
    shapes = dict(img=(crop_h, width, 3), tmap=(crop_h, width), d_img=(crop_h, width, 3),
                  d_tmap=(crop_h, width))
    tensors = dict(img=img, tmap=tmap, d_img=d_img, d_tmap=d_tmap)
    for name, shape in shapes.items():
        t = tensors[name]
        if t.device != attr.device or t.dtype != torch.float32 or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(f"backward_blend: {name} must be contiguous float32 {shape} on "
                             f"{attr.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    d_attr = torch.empty_like(attr)
    err = _backward_kernel()(
        attr.data_ptr(), attr.stride(0), starts.data_ptr(), ends.data_ptr(), starts.shape[0],
        tiles_x, cfg.tile_w, cfg.tile_h, int(row0), width, crop_h, cfg.alpha_max,
        cfg.alpha_min, cfg.t_min, img.data_ptr(), tmap.data_ptr(), d_img.data_ptr(),
        d_tmap.data_ptr(), d_attr.data_ptr(), _build.stream_ptr(attr.device))
    _build.check(err, "backward blend kernel")
    BACKWARD_LAUNCHES += 1
    return d_attr


class _RasterCore(torch.autograd.Function):
    """(img, tmap, tile_overflow) = forward_blend(attr, ...), whose backward
    is :func:`backward_blend` (``_raster_core`` of rasterize_pallas.py)."""

    @staticmethod
    def forward(ctx, attr, starts, ends, tiles_x, row0, width, crop_h, cfg):
        img, tmap, tile_overflow = forward_blend(attr, starts, ends, tiles_x, row0, width,
                                                 crop_h, cfg)
        ctx.save_for_backward(attr, starts, ends, img, tmap)
        ctx.static = (tiles_x, row0, width, crop_h, cfg)
        ctx.mark_non_differentiable(tile_overflow)
        return img, tmap, tile_overflow

    @staticmethod
    def backward(ctx, d_img, d_tmap, _d_overflow):
        attr, starts, ends, img, tmap = ctx.saved_tensors
        # An unused output's cotangent (usually T's) counts as zeros.
        d_img = torch.zeros_like(img) if d_img is None else d_img.contiguous()
        d_tmap = torch.zeros_like(tmap) if d_tmap is None else d_tmap.contiguous()
        d_attr = backward_blend(attr, starts, ends, img, tmap, d_img, d_tmap, *ctx.static)
        return (d_attr,) + (None,) * 7


def rasterize(
    pg: ProcessedGaussians,
    binned: BinnedInstances,
    width: int,
    height: int,
    cfg: RenderConfig,
    row0: int = 0,
    nrows: int | None = None,
):
    """Render the full image, or the strip of ``nrows`` tile rows starting
    at ``row0``. Returns (rgb [H, W, 3] or [nrows*tile_h, W, 3], aux)."""
    tiles_x, tiles_y = cfg.tile_grid(width, height)
    strip = nrows is not None
    if not strip:
        nrows = tiles_y
    crop_h = height if not strip else nrows * cfg.tile_h
    attr = pack_instances(pg, binned)
    img, tmap, tile_overflow = _RasterCore.apply(
        attr, binned.tile_start, binned.tile_end, tiles_x, row0, width, crop_h, cfg)
    counts = binned.tile_end - binned.tile_start
    aux = dict(
        transmittance=tmap,
        tile_overflow=tile_overflow,
        capacity_overflow=binned.overflow,
        gauss_overflow=binned.gauss_overflow,
        num_instances=binned.num_instances,
        max_tile_count=counts.max(),
    )
    return img, aux
