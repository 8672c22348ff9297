"""Tile rasterization: attribute gather and forward blend.

Counterpart of two JAX modules: ``tpusplat/ops/rasterize_pallas.py``
(forward half: ``pack_instances``, the forward kernel, ``_assemble_strip``)
and ``tpusplat/ops/rasterize_xla.py`` (the chunked-cumprod blend, which is
the plain version here).

  * :func:`pack_instances` gathers the per-instance attributes into a
    [9, C] float32 slab (rows: uv.x, uv.y, conic a/b/c, opacity, r/g/b;
    dead slots, whose gid is N, read Gaussian N-1 and lie outside every
    tile range). The JAX slab's 7 pad rows and WIN pad columns were for TPU
    tiling and DMA windows and are dropped.
  * :func:`forward_blend` routes by device: a CPU tensor goes through
    :func:`blend_plain`, a CUDA tensor through ``csrc/rasterize_forward.cu``
    (or the call raises). The kernel has no backward yet: a CUDA call that
    needs a gradient raises.

The blend: per pixel, front to back, ``alpha = min(0.99, op exp(power))``;
instances with ``power > 0`` or ``alpha < 1/255`` are skipped; an instance
adds colour only while the inclusive transmittance stays >= 1e-4, and the
final T multiplies every passing instance (``render.comp:68-88``).
"""

from __future__ import annotations

import ctypes

import torch

from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops import _build
from tpusplat_torch.ops.binning import BinnedInstances
from tpusplat_torch.ops.preprocess import ProcessedGaussians

ATTR_ROWS = 9
A_UVX, A_UVY, A_CA, A_CB, A_CC, A_OP, A_CR, A_CG, A_CB_ = range(ATTR_ROWS)

FORWARD_LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)

_sig_set = False


def _lib():
    global _sig_set
    lib = _build.load("rasterize_forward")
    if not _sig_set:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tpusplat_forward.argtypes = [p, ctypes.c_longlong, p, p, i, i, i, i, i, i, i,
                                         f, f, f, p, p, p]
        lib.tpusplat_forward.restype = i
        _sig_set = True
    return lib


def pack_instances(pg: ProcessedGaussians, binned: BinnedInstances) -> torch.Tensor:
    """The [9, C] attribute slab of the sorted instances (differentiable)."""
    n = pg.uv.shape[0]
    table = torch.cat(
        [pg.uv.T, pg.conic.T, pg.opacity[None, :], pg.color.T], dim=0
    )  # [9, N]
    return table.index_select(1, torch.clamp_max(binned.gauss_id, n - 1))


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


def _forward_cuda(attr, starts, ends, tiles_x, row0, width, crop_h, cfg):
    global FORWARD_LAUNCHES
    if attr.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "forward_blend: the CUDA backward blend is not ported yet; render "
            "under torch.no_grad() on the card")
    num_tiles = starts.shape[0]
    npx = cfg.tile_w * cfg.tile_h
    if attr.dtype != torch.float32 or attr.dim() != 2 or attr.shape[0] != ATTR_ROWS \
            or not attr.is_contiguous():
        raise ValueError(f"forward_blend: attr must be contiguous float32 [{ATTR_ROWS}, C], "
                         f"got {attr.dtype} {tuple(attr.shape)}")
    for name, t in dict(starts=starts, ends=ends).items():
        if t.device != attr.device or t.dtype != torch.int32 or t.shape != (num_tiles,) \
                or not t.is_contiguous():
            raise ValueError(f"forward_blend: {name} must be contiguous int32 [{num_tiles}] "
                             f"on {attr.device}")
    if num_tiles == 0 or num_tiles % tiles_x or not 0 < npx <= 1024:
        raise ValueError(f"forward_blend: {num_tiles} tiles, tiles_x {tiles_x}, "
                         f"{npx} pixels a tile")
    if crop_h > (num_tiles // tiles_x) * cfg.tile_h or width > tiles_x * cfg.tile_w:
        raise ValueError("forward_blend: the tiles do not cover the output")
    img = torch.empty((crop_h, width, 3), dtype=torch.float32, device=attr.device)
    tmap = torch.empty((crop_h, width), dtype=torch.float32, device=attr.device)
    err = _lib().tpusplat_forward(
        attr.data_ptr(), attr.stride(0), starts.data_ptr(), ends.data_ptr(), num_tiles,
        tiles_x, cfg.tile_w, cfg.tile_h, int(row0), width, crop_h, cfg.alpha_max,
        cfg.alpha_min, cfg.t_min, img.data_ptr(), tmap.data_ptr(),
        _build.stream_ptr(attr.device))
    _build.check(err, "forward blend kernel")
    FORWARD_LAUNCHES += 1
    return img, tmap, torch.zeros((), dtype=torch.int32, device=attr.device)


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
    img, tmap, tile_overflow = forward_blend(
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
