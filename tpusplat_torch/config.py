"""Static render configuration (counterpart of ``tpusplat/config.py``).

The fields, their defaults and their validation are those of the JAX
package, with one exception: there is no ``use_pallas``. The port routes
by tensor device instead of by a flag: a CPU tensor goes through the plain
PyTorch version of each kernel, a CUDA tensor through the hand-written
kernel (or the call raises). ``TPUSPLAT_USE_PALLAS`` is therefore ignored.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Hashable configuration for the splatting pipeline.

    Attributes (as in the JAX package unless noted):
      tile_w, tile_h: raster tile size in pixels (16x16, the reference's
        ``common.glsl:1-2``; required for bit-parity of the tile binning).
      sh_degree: max spherical-harmonics degree evaluated (0..3).
      color_clamp: "red" (reference quirk: only the red channel clamped at
        zero after the +0.5 SH offset), "all" or "none".
      capacity_mult / capacity: static instance-buffer capacity, as a
        multiple of N or explicit.
      scale_modifier: global multiplier on activated scales.
      z_near_cull: view-space depth cull threshold (0.2).
      dilation: screen-space covariance dilation (+0.3 on the diagonal).
      alpha_max / alpha_min / t_min: blending constants (0.99, 1/255, 1e-4).
      tile_chunk: tiles per step of the plain blend (memory knob, no effect
        on results).
      gauss_chunk: per-tile instance chunk of the plain blend (no effect on
        results).
      max_per_tile: cap on instances considered per tile by the plain blend;
        the excess is reported as ``tile_overflow``. The CUDA forward kernel
        walks the true range and does not use it.
      mm_precision: validated as in the JAX package, but has no effect in
        the port: the CUDA blend is fp32 with no matrix product, and the
        plain blend runs in fp32.
      tight_radius: opacity-aware tile AABB (changes only the tile lists,
        never the image).
      debug_checks: the validation counters of
        :mod:`tpusplat_torch.ops.validate` in ``aux["debug"]``; ``render``
        raises on a violation.
      strip_gauss_mult, strip_gauss_margin_rows, grad_exchange,
        grad_a2a_mult: the tile-sharded path's knobs (strip compaction's
        stream cap, the dense or compact gradient exchange and its bucket
        capacity; :mod:`tpusplat_torch.parallel`).
    """

    tile_w: int = 16
    tile_h: int = 16
    mm_precision: str = "highest"
    sh_degree: int = 3
    color_clamp: str = "red"
    capacity_mult: float = 8
    capacity: int | None = None
    scale_modifier: float = 1.0
    z_near_cull: float = 0.2
    dilation: float = 0.3
    alpha_max: float = 0.99
    alpha_min: float = 1.0 / 255.0
    t_min: float = 1e-4
    tile_chunk: int = 64
    gauss_chunk: int = 64
    max_per_tile: int = 1024
    tight_radius: bool = False
    debug_checks: bool = False
    strip_gauss_mult: float = 2.0
    strip_gauss_margin_rows: int = 4
    grad_exchange: str = "dense"
    grad_a2a_mult: float = 1.3

    def __post_init__(self):
        if self.mm_precision not in ("highest", "default"):
            raise ValueError(
                f"mm_precision must be 'highest' or 'default', got "
                f"{self.mm_precision!r}"
            )
        if self.color_clamp not in ("red", "all", "none"):
            raise ValueError(f"unknown color_clamp {self.color_clamp!r}")
        if self.grad_exchange not in ("dense", "compact"):
            raise ValueError(
                f"grad_exchange must be 'dense' or 'compact', got "
                f"{self.grad_exchange!r}"
            )

    def instance_capacity(self, num_gaussians: int) -> int:
        cap = self.capacity if self.capacity is not None else int(
            self.capacity_mult * num_gaussians
        )
        return max(1024, -(-cap // 1024) * 1024)

    def with_env_overrides(self) -> "RenderConfig":
        """Apply the JAX package's TPUSPLAT_* environment overrides (CLI flag
        > env var > default: callers apply this to the defaults, then
        overlay explicit CLI choices)."""

        def _bool(v: str) -> bool:
            return v.strip().lower() not in ("", "0", "false", "off", "no")

        env = {
            "TPUSPLAT_TIGHT_RADIUS": ("tight_radius", _bool),
            "TPUSPLAT_DEBUG_CHECKS": ("debug_checks", _bool),
            "TPUSPLAT_CAPACITY_MULT": ("capacity_mult", float),
            "TPUSPLAT_CAPACITY": ("capacity", int),
            "TPUSPLAT_MAX_PER_TILE": ("max_per_tile", int),
            "TPUSPLAT_SH_DEGREE": ("sh_degree", int),
            "TPUSPLAT_MM_PRECISION": ("mm_precision", str),
            "TPUSPLAT_GRAD_EXCHANGE": ("grad_exchange", str),
            "TPUSPLAT_GRAD_A2A_MULT": ("grad_a2a_mult", float),
            "TPUSPLAT_STRIP_GAUSS_MULT": ("strip_gauss_mult", float),
        }
        updates = {}
        for var, (field, conv) in env.items():
            raw = os.environ.get(var)
            if raw is not None:
                updates[field] = conv(raw)
        return dataclasses.replace(self, **updates) if updates else self

    def strip_gauss_capacity(self, n: int, nrows: int, tiles_y: int) -> int | None:
        """Static Gaussian-stream cap for one strip of ``nrows`` tile rows
        (None = compaction off / not worthwhile)."""
        if self.strip_gauss_mult <= 0 or nrows >= tiles_y:
            return None
        frac = min(1.0, (nrows + self.strip_gauss_margin_rows) / tiles_y)
        cap = int(n * frac * self.strip_gauss_mult)
        cap = max(1024, -(-cap // 1024) * 1024)
        return cap if cap < n else None

    def tile_grid(self, width: int, height: int) -> tuple[int, int]:
        """(tiles_x, tiles_y), ceil-divided like ``preprocess.comp:127``."""
        return (
            (width + self.tile_w - 1) // self.tile_w,
            (height + self.tile_h - 1) // self.tile_h,
        )


def regrow(cfg: RenderConfig, counters: dict, shard_gaussians: int):
    """The shared overflow-recovery policy: each overflow channel grows its
    own capacity. ``counters`` values may be tensors, numpy arrays or ints
    (summed here). Returns (new_cfg, log_dict); log_dict is None when
    nothing overflowed (new_cfg is then ``cfg`` itself)."""

    def get(k):
        v = counters.get(k, 0)
        if hasattr(v, "sum"):
            v = v.sum()
        return int(v)

    changes: dict = {}
    updates: dict = {}
    a2a = get("a2a_overflow")
    if a2a > 0:
        updates["grad_a2a_mult"] = cfg.grad_a2a_mult * 1.5
        changes["a2a_overflow"] = a2a
    gauss = get("gauss_overflow")
    if gauss > 0:
        updates["strip_gauss_mult"] = cfg.strip_gauss_mult * 1.5
        changes["gauss_overflow"] = gauss
    tile = get("tile_overflow")
    if tile > 0:
        updates["max_per_tile"] = cfg.max_per_tile * 2
        changes["tile_overflow"] = tile
    cap = get("capacity_overflow")
    if cap > 0:
        cap_now = cfg.instance_capacity(shard_gaussians)
        updates["capacity"] = int((cap_now + cap) * 1.3)
        changes["capacity_overflow"] = cap
    if not updates:
        return cfg, None
    changes.update({k + "_regrow": v for k, v in updates.items()})
    return dataclasses.replace(cfg, **updates), changes


# Spherical-harmonics constants (common.glsl:16-33).
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
