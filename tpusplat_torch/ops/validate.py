"""Runtime validation behind ``RenderConfig(debug_checks=True)``
(counterpart of ``tpusplat/ops/validate.py``).

What is worth guarding at run time is numerical and invariant corruption:
NaN or Inf in the per-Gaussian attributes (which silently poisons
training), and broken tile-range invariants that the blend kernels trust
(start <= end <= capacity, sorted tile ids, payload ids in range). Every
check is a 0-d int32 violation counter on the device of its inputs, so a
frame with the checks on reads nothing back; the host raises through
:func:`raise_on_violations`. The checks read the pipeline's outputs and
change none of them.
"""

from __future__ import annotations

import torch

from tpusplat_torch.ops.binning import BinnedInstances
from tpusplat_torch.ops.preprocess import ProcessedGaussians


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def _count_nonfinite(x: torch.Tensor) -> torch.Tensor:
    return _count(~torch.isfinite(x.detach()))


def check_processed(pg: ProcessedGaussians) -> dict[str, torch.Tensor]:
    """Finite values in every preprocess output (all lanes: culled lanes are
    kept finite by construction, so a NaN anywhere means corrupt parameters
    or a broken guard), a positive conic diagonal and a valid tile box for
    every visible Gaussian."""
    vis = pg.ntiles > 0
    conic, aabb = pg.conic.detach(), pg.aabb
    return {
        "nonfinite_uv": _count_nonfinite(pg.uv),
        "nonfinite_conic": _count_nonfinite(pg.conic),
        "nonfinite_opacity": _count_nonfinite(pg.opacity),
        "nonfinite_color": _count_nonfinite(pg.color),
        "nonfinite_depth": _count_nonfinite(pg.depth),
        "bad_conic_sign": _count(vis & ((conic[:, 0] < 0.0) | (conic[:, 2] < 0.0))),
        "bad_aabb": _count(vis & ((aabb[:, 0] > aabb[:, 2]) | (aabb[:, 1] > aabb[:, 3])
                                  | (aabb[:, 0] < 0) | (aabb[:, 1] < 0))),
    }


def check_binned(binned: BinnedInstances, num_gaussians: int) -> dict[str, torch.Tensor]:
    """The invariants the blend trusts: sorted tile ids, payload ids in
    [0, N], ranges with 0 <= start <= end <= capacity, and end[t] ==
    start[t + 1] (an empty tile has start == end)."""
    capacity = binned.tile_id.shape[0]
    tid, gid = binned.tile_id, binned.gauss_id
    starts, ends = binned.tile_start, binned.tile_end
    return {
        "unsorted_tile_id": _count(tid[1:] < tid[:-1]),
        "gid_out_of_range": _count((gid < 0) | (gid > num_gaussians)),
        "bad_tile_range": _count((starts > ends) | (starts < 0) | (ends > capacity)),
        "range_gap": _count(starts[1:] != ends[:-1]),
        "negative_overflow": torch.clamp_min(-binned.overflow, 0).to(torch.int32),
    }


def check_image(img: torch.Tensor) -> dict[str, torch.Tensor]:
    return {"nonfinite_pixels": _count_nonfinite(img)}


def raise_on_violations(aux: dict) -> None:
    """Raise ``RuntimeError`` if any counter of ``aux["debug"]`` is nonzero
    (a no-op without the key). The only place the counters are read on
    the host."""
    checks = aux.get("debug")
    if checks is None:
        return
    values = torch.stack([v.to(torch.int64) for v in checks.values()]).tolist()  # one read
    bad = {k: v for k, v in zip(checks, values) if v != 0}
    if bad:
        raise RuntimeError(f"tpusplat_torch validation failed: {bad}")
