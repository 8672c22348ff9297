"""The backward kernel's cull: ``pass_extent_plain`` (the formula by which
``csrc/rasterize_backward.cu`` skips an instance for a warp whose pixels lie
outside the instance's box) against the JAX package's pass test, the ``ok``
of ``rasterize_pallas._chunk_alpha``. Every (instance, pixel) pair that
passes there must lie inside the box, whose edges are formed in float32 as
the kernel forms them; no tolerance. On a small scene the cull must drop
some (instance, warp) pairs, with the kernel's warps (``warp_pixels``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusplat.config import RenderConfig as JaxConfig
from tpusplat.ops import rasterize_pallas as rp
from tpusplat_torch import RenderConfig, look_at_camera, random_scene
from tpusplat_torch.ops import binning, rasterize
from tpusplat_torch.ops.preprocess import preprocess

torch.set_num_threads(2)

ALPHA_MIN = JaxConfig().alpha_min
GRID = 64  # pixels a side of the grid the instances are tested on


def _instances(kind, rng):
    """uv [CK, 2], conic [CK, 3] (a, b, c), opacity [CK], float32."""
    k = rp.CK
    uv = rng.uniform(-8, GRID + 8, (k, 2))
    sig = np.exp(rng.uniform(np.log(0.3), np.log(30.0), (k, 2)))
    rho = rng.uniform(-0.9, 0.9, k)
    op = rng.uniform(0, 1, k)
    if kind == "opacity_at_threshold":
        op = ALPHA_MIN * np.array([1 - 1e-6, 1 + 1e-6, 1.0, 1 + 1e-4, 1 - 1e-4])[
            np.arange(k) % 5]
        op[::7] = 1.0
        uv = np.round(uv)  # a pixel at the centre, where power is 0
    elif kind == "near_singular":  # b^2 -> ac
        rho = np.sign(rho) * (1 - 10.0 ** -rng.uniform(1, 9, k))
        op = np.where(np.arange(k) % 2, 1.0, op)
    elif kind == "tiny_and_huge":
        sig = np.where(np.arange(k)[:, None] % 2, 0.01, 1e4) * rng.uniform(0.5, 2, (k, 2))
        op = np.where(np.arange(k) % 3 == 0, 1.0, op)
    elif kind == "off_grid":  # centres between, on and far from pixel centres
        uv = np.round(uv) + rng.choice([0.0, 0.5, 1e-3, -1e-3, 0.4999], (k, 2))
        far = len(uv[::5])
        uv[::5] += rng.choice([-1, 1], (far, 2)) * rng.uniform(30, 300, (far, 2))
    cov = np.stack([sig[:, 0] ** 2, rho * sig[:, 0] * sig[:, 1], sig[:, 1] ** 2], -1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    conic = np.stack([cov[:, 2], -cov[:, 1], cov[:, 0]], -1) / det[:, None]
    conic = conic.astype(np.float32)
    if kind == "on_boundary":  # a pixel just at the pass threshold
        pix = rng.integers(8, GRID - 8, (k, 2)).astype(np.float32)
        ang = rng.uniform(0, 2 * np.pi, k)
        d = np.stack([np.cos(ang), np.sin(ang)], -1) * sig * rng.uniform(0.5, 3, (k, 1))
        uv = pix + d.astype(np.float32)
        dx, dy = (uv - pix).T.astype(np.float64)
        a, b, c = conic.T.astype(np.float64)
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        op = np.minimum(1.0, ALPHA_MIN * np.exp(-power) * (1 + 1e-6))
    return uv.astype(np.float32), conic, op.astype(np.float32)


def _jax_ok(uv, conic, op):
    """[CK, P] pass mask of _chunk_alpha over the GRID x GRID pixel centres."""
    slab = np.zeros((rp.CK, rp.ATTR_W), np.float32)
    slab[:, rp.A_UVX], slab[:, rp.A_UVY] = uv[:, 0], uv[:, 1]
    slab[:, rp.A_CA:rp.A_CC + 1] = conic
    slab[:, rp.A_OP] = op
    ys, xs = np.meshgrid(np.arange(GRID), np.arange(GRID), indexing="ij")
    px = jnp.asarray(xs.reshape(1, -1), jnp.float32)
    py = jnp.asarray(ys.reshape(1, -1), jnp.float32)
    ch = rp._chunk_alpha(jnp.asarray(slab), 0, rp.CK, px, py, JaxConfig())
    return np.asarray(ch["ok"]), xs.reshape(-1), ys.reshape(-1)


@pytest.mark.parametrize("kind", ["random", "opacity_at_threshold", "near_singular",
                                  "tiny_and_huge", "off_grid", "on_boundary"])
def test_pass_extent_holds_every_passing_pair(kind):
    uv, conic, op = _instances(kind, np.random.default_rng(5))
    ok, xs, ys = _jax_ok(uv, conic, op)
    assert ok.any()
    h = rasterize.pass_extent_plain(torch.from_numpy(conic), torch.from_numpy(op), ALPHA_MIN)
    assert h.dtype == torch.float32
    u = torch.from_numpy(uv)
    lo, hi = (u - h).numpy()[:, None, :], (u + h).numpy()[:, None, :]  # float32 edges
    pix = np.stack([xs, ys], -1).astype(np.float32)[None]  # [1, P, 2]
    inside = ((pix >= lo) & (pix <= hi)).all(-1)  # [CK, P]
    missed = ok & ~inside
    assert not missed.any(), f"{missed.sum()} passing pairs outside the box"
    # The cull is not vacuous: finite boxes are held, and pairs are culled.
    assert torch.isfinite(h).all(-1).any()
    assert (~inside).any()


def test_pass_extent_off_and_empty():
    """+inf (no cull) for non-finite inputs and conics that are not
    positive definite, -inf (cull all) below the opacity threshold."""
    conic = torch.tensor([[1.0, 0.0, 1.0], [np.nan, 0.0, 1.0], [1.0, 2.0, 1.0],
                          [-1.0, 0.0, -1.0], [1.0, 0.0, 1.0], [1.0, 0.0, 1.0]])
    op = torch.tensor([0.5, 0.5, 0.5, 0.5, ALPHA_MIN * 0.9, 0.0])
    h = rasterize.pass_extent_plain(conic, op, ALPHA_MIN).numpy()
    assert np.isfinite(h[0]).all() and (h[0] > 1).all()
    assert (h[1:4] == np.inf).all()
    assert (h[4:] == -np.inf).all()


@pytest.mark.parametrize("tile_w,tile_h", [(16, 16), (32, 8), (8, 4), (24, 4), (16, 2)])
def test_warp_pixels_partition_the_tile(tile_w, tile_h):
    """Every pixel in exactly one warp; 8 x 4 blocks where the tile divides
    into them."""
    wp = rasterize.warp_pixels(tile_w, tile_h)
    assert wp.shape == (tile_w * tile_h // 32, 32)
    assert torch.equal(wp.flatten().sort().values, torch.arange(tile_w * tile_h))
    if tile_w % 8 == 0 and tile_h % 4 == 0:
        x, y = wp % tile_w, wp // tile_w
        assert ((x.amax(1) - x.amin(1)) == 7).all() and ((y.amax(1) - y.amin(1)) == 3).all()


def test_cull_drops_instance_warp_pairs_on_a_small_scene():
    """The share of (instance, warp) pairs whose box misses the rectangle
    of the warp's pixels (an 8 x 4 block of a 16 x 16 tile) is above 0."""
    w, h = 96, 64
    cfg = RenderConfig(sh_degree=1)
    params = random_scene(600, seed=2, sh_degree=1, scale_range=(0.01, 0.1), device="cpu")
    cam = look_at_camera([0.0, 0.3, 6.0], [0.0, 0.0, 0.0], w, h, fov_deg=60.0, device="cpu")
    pg = preprocess(params, cam, cfg)
    binned = binning.bin_and_sort(pg, w, h, cfg)
    live = int(binned.num_instances)
    attr = rasterize.pack_instances(pg, binned)[:, :live]
    tile = binned.tile_id[:live].long()
    tiles_x = cfg.tile_grid(w, h)[0]
    ext = rasterize.pass_extent_plain(attr[2:5].T, attr[5], cfg.alpha_min)
    wp = rasterize.warp_pixels(cfg.tile_w, cfg.tile_h)
    wx, wy = (wp % cfg.tile_w).float(), (wp // cfg.tile_w).float()
    x0 = (tile % tiles_x * cfg.tile_w).float()[:, None]
    y0 = (tile // tiles_x * cfg.tile_h).float()[:, None]
    uvx, uvy = attr[0, :, None], attr[1, :, None]
    meets = (uvx + ext[:, :1] >= x0 + wx.amin(1)) & (uvx - ext[:, :1] <= x0 + wx.amax(1)) \
        & (uvy + ext[:, 1:] >= y0 + wy.amin(1)) & (uvy - ext[:, 1:] <= y0 + wy.amax(1))
    assert live > 500 and 0 < 1 - float(meets.float().mean()) < 1
