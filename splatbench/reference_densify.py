"""The plain densify round: 3DGS's clone / split / prune under a fixed number
of slots, in plain PyTorch, and the readings that compare the program's
round with it.

Independent of the program: it imports neither ``jax``, the JAX package nor
the port. It is written from the recipe (Kerbl et al. 2023,
graphdeco-inria/gaussian-splatting, ``gaussian_model.py``
``densify_and_prune`` with ``arguments/__init__.py``'s
``OptimizationParams``) and from the fixed-slot contract the port's
docstring states (``tpusplat_torch/train/densify.py``):

* candidates: alive slots whose average gradient (the summed norm over the
  number of steps the Gaussian was visible) is at least the threshold;
* they are ranked by that gradient, a stable descending sort, and the j-th
  of them takes the j-th free slot in ascending order, while free slots
  last; a candidate without one does nothing;
* a candidate whose largest scale is at most ``percent_dense`` times the
  extent clones: its slot's copy goes to the granted slot; a larger one
  splits: two samples ``mean + R(q) (z * scale)``, z standard normal, with
  the scales divided by 1.6, one in place and one in the granted slot;
* prune: alive slots (the granted ones included) whose opacity is below
  the minimum, or whose largest scale is above ``max_world_scale`` times the
  extent, or, where enabled, whose screen radius is above the limit;
* Adam's moments are zeroed on every touched slot (granted, split) and on
  every dead slot; the statistics are reset.

Departures from 3DGS, the port's and the JAX package's alike: the gradient
is that of the 3D mean, not of the projected 2D mean; a round grants at
most as many candidates as there are free slots, where 3DGS grows its
tensors; the scales divided by 1.6 are subtracted as ``log(1.6)`` from the
log-scales. This file does not reproduce the port's random stream
(threefry), so the split positions are checked by their statistics
(:func:`split_noise`) and everything else slot by slot (:func:`compare`).

Also here: the densify statistics of a plain step (:func:`step_stats`),
from ``reference.project``.
"""

from __future__ import annotations

import math

import torch

from splatbench import reference

PARAMS = reference.FIELDS  # the trainable fields, each [N, ...]
STATS = ("grad_accum", "grad_count", "max_radii")
# DensifyConfig()'s defaults, 3DGS's: densify_grad_threshold, percent_dense,
# min opacity; the world-size prune at 0.1 of the extent; no screen-size
# prune before the first opacity reset.
DENSIFY = dict(grad_threshold=2e-4, percent_dense=0.01, min_opacity=0.005,
               split_scale_div=1.6, max_world_scale=0.1, max_screen_radius=0.0)
FAULTS = ("clone_only", "moments_kept", "noise_zero")


def _rotation(q: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] rotation matrices of [N, 4] (w, x, y, z) quaternions."""
    q = q / torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], 1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], 1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], 1),
    ], 1)


@torch.no_grad()
def densify_round(state: dict, extent: float, noise=None, noise2=None, generator=None,
                  fault: str | None = None) -> dict:
    """One round on ``state``: a dict of the parameter fields and ``alive``,
    ``mu`` and ``nu`` (dicts by field) and the statistics. Returns
    ``state`` (the new one) and the decisions: ``target`` [N] (the granted
    slot of each granted candidate, -1 elsewhere), ``candidates``,
    ``granted``, ``split``
    (granted candidates that split), ``is_target`` and ``pruned`` [N] bool.
    ``noise``/``noise2`` ([N, 3]) are the split draws of the granted slot
    and of the slot in place; when not given they are drawn from
    ``generator``. ``fault`` plants one of ``FAULTS``: ``clone_only``
    (every candidate clones), ``moments_kept`` (no moment is zeroed),
    ``noise_zero`` (both draws 0). The settings are :data:`DENSIFY`."""
    cfg = DENSIFY
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    alive = state["alive"]
    n, dev = alive.shape[0], alive.device
    dt = state["means"].dtype
    count = state["grad_count"]
    avg = torch.where(count > 0, state["grad_accum"] / torch.clamp_min(count, 1), 0.0)
    cand = alive & (avg >= cfg["grad_threshold"])
    scales = torch.exp(state["log_scales"])
    large = scales.max(dim=1).values > cfg["percent_dense"] * extent
    if fault == "clone_only":
        large = torch.zeros_like(large)

    ids = torch.nonzero(cand).squeeze(1)
    ranked = ids[torch.sort(avg[ids], descending=True, stable=True).indices]
    free = torch.nonzero(~alive).squeeze(1)  # ascending
    k = min(ranked.shape[0], free.shape[0])
    src, dst = ranked[:k], free[:k]
    target = torch.full((n,), -1, dtype=torch.int64, device=dev)
    target[src] = dst
    granted = target >= 0
    split = granted & large
    is_target = torch.zeros(n, dtype=torch.bool, device=dev)
    is_target[dst] = True

    out = {f: state[f].clone() for f in PARAMS}
    for f in PARAMS:
        out[f][dst] = state[f][src]
    s_src = src[large[src]]  # the granted candidates that split
    s_dst = target[s_src]
    if s_src.numel():
        if noise is None or noise2 is None:
            z = torch.randn((2, n, 3), generator=generator, device=dev).to(dt)
            noise, noise2 = (z[0], z[1]) if noise is None else (noise, z[1])
        if fault == "noise_zero":
            noise, noise2 = torch.zeros_like(noise), torch.zeros_like(noise2)
        rot = _rotation(state["quats"][s_src])
        sc = scales[s_src]
        mean = state["means"][s_src]
        out["means"][s_dst] = mean + (rot @ (noise[s_src] * sc)[:, :, None])[:, :, 0]
        out["means"][s_src] = mean + (rot @ (noise2[s_src] * sc)[:, :, None])[:, :, 0]
        shrunk = state["log_scales"][s_src] - math.log(cfg["split_scale_div"])
        out["log_scales"][s_dst] = shrunk
        out["log_scales"][s_src] = shrunk

    grown = alive | is_target
    prune = torch.sigmoid(out["opacities"]) < cfg["min_opacity"]
    if cfg["max_world_scale"] > 0:
        prune |= torch.exp(out["log_scales"]).max(dim=1).values > cfg["max_world_scale"] * extent
    if cfg["max_screen_radius"] > 0:
        prune |= state["max_radii"] > cfg["max_screen_radius"]
    pruned = grown & prune
    out["alive"] = grown & ~prune

    fresh = is_target | split | ~out["alive"]
    if fault == "moments_kept":
        fresh = torch.zeros_like(fresh)
    for m in ("mu", "nu"):
        out[m] = {f: torch.where(fresh.reshape((n,) + (1,) * (state[m][f].dim() - 1)), 0.0,
                                 state[m][f]) for f in PARAMS}
    for f in STATS:
        out[f] = torch.zeros_like(state[f])
    return dict(state=out, target=target, candidates=cand, granted=granted, split=split,
                is_target=is_target, pruned=pruned)


def counts(ref: dict) -> dict:
    """The round's counts, as the port's tracer names them."""
    g, s = ref["granted"], ref["split"]
    return dict(candidates=int(ref["candidates"].sum()), granted=int(g.sum()), cloned=int((g & ~s).sum()), split=int(s.sum()),
                pruned=int(ref["pruned"].sum()), alive=int(ref["state"]["alive"].sum()))


# -- the statistics of a plain step --

def screen_radius(pr: dict, tight_radius: bool) -> torch.Tensor:
    """[N] pixel radius of each visible Gaussian (0 elsewhere), from
    ``reference.project``'s conic and opacity: the 2D covariance is the
    conic's inverse, taken in float64."""
    a_c, b_c, c_c = (pr["attr"][:, i].detach().double() for i in (2, 3, 4))
    det_c = a_c * c_c - b_c * b_c
    good = pr["visible"] & (det_c > 0)
    det_c = torch.where(good, det_c, torch.ones_like(det_c))
    a, c = c_c / det_c, a_c / det_c
    det = 1.0 / det_c
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))
    if tight_radius:
        op = pr["attr"][:, 5].detach().double()
        mult2 = 2.0 * torch.log(torch.clamp_min(255.0 * op, 1e-12))
        tight = torch.ceil(torch.sqrt(torch.clamp_min(lam, 0.0) * torch.clamp_min(mult2, 0.0)))
        radius = torch.where(255.0 * op < 1.0, torch.zeros_like(lam),
                             torch.minimum(radius, tight + 2.0))
    return torch.where(good, radius, torch.zeros_like(radius)).float()


@torch.no_grad()
def step_stats(p: dict, cam: dict, grads: dict, conf: dict) -> dict:
    """One step's additions to the statistics: the norm of each Gaussian's
    ``d loss / d means``, whether it was visible (1.0 or 0.0) and its screen
    radius (0 where not visible)."""
    pr = reference.project(p, cam, conf["sh_degree"], conf["tight_radius"])
    return dict(grad_accum=torch.linalg.vector_norm(grads["means"].float(), dim=1),
                grad_count=pr["visible"].float(),
                max_radii=screen_radius(pr, conf["tight_radius"]))


def accumulate(stats: dict | None, add: dict) -> dict:
    """3DGS's statistics after one more step: sums and the radius's max."""
    if stats is None:
        return dict(add)
    return dict(grad_accum=stats["grad_accum"] + add["grad_accum"],
                grad_count=stats["grad_count"] + add["grad_count"],
                max_radii=torch.maximum(stats["max_radii"], add["max_radii"]))


# -- the readings --

def split_noise(pre: dict, post: dict, ref: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The standard normals behind the program's split positions,
    ``z = R(q)^T (x - mean) / scale`` from the pre-round mean, rotation and
    scales, at the reference's split slots: (z of the granted slots, z of
    the slots in place), each [splits, 3], float64."""
    src = torch.nonzero(ref["split"]).squeeze(1)
    dst = ref["target"][src]
    rot = _rotation(pre["quats"][src].double())
    mean = pre["means"][src].double()
    scale = torch.exp(pre["log_scales"][src].double())

    def z(x):
        return (rot.transpose(1, 2) @ (x.double() - mean)[:, :, None])[:, :, 0] / scale
    return z(post["means"][dst]), z(post["means"][src])


def noise_readings(z1: torch.Tensor, z2: torch.Tensor) -> dict:
    """Each draw's statistics in standard errors, the largest over the
    (draw, axis) columns, so that one limit serves any number of splits n:
    the mean of z times sqrt(n) (its standard error is 1 / sqrt(n)), |std -
    1| times sqrt(2 n) (the sample std's is about 1 / sqrt(2 n)), and the
    two draws' correlation on each axis times sqrt(n) (0 where a draw is
    constant: its std reads that). 0 with fewer than 2 splits."""
    n = z1.shape[0]
    if n < 2:
        return dict(split_noise_mean=0.0, split_noise_std_gap=0.0, split_noise_corr=0.0)
    z = torch.cat([z1, z2], dim=1)  # [n, 6]
    mean = z.mean(dim=0)
    std = z.std(dim=0)
    c1, c2 = z1 - z1.mean(dim=0), z2 - z2.mean(dim=0)
    den = torch.sqrt((c1 * c1).sum(dim=0) * (c2 * c2).sum(dim=0))
    corr = torch.where(den > 0, (c1 * c2).sum(dim=0) / den, 0.0)  # 0 for a constant draw
    return dict(split_noise_mean=float(mean.abs().max()) * math.sqrt(n),
                split_noise_std_gap=float((std - 1).abs().max()) * math.sqrt(2 * n),
                split_noise_corr=float(corr.abs().max()) * math.sqrt(n))


def decisions(pre: dict, post: dict) -> dict:
    """What a round decided, read from its state before and after: a slot
    is a granted target where it was dead and its parameters changed, a
    split where it was alive and they changed, pruned where it was alive
    or granted and is dead after."""
    changed = torch.zeros_like(pre["alive"])
    for f in PARAMS:
        diff = pre[f] != post[f]
        changed |= diff.reshape(diff.shape[0], -1).any(dim=1)
    target = ~pre["alive"] & changed
    return dict(alive=post["alive"], is_target=target, split=pre["alive"] & changed,
                pruned=(pre["alive"] | target) & ~post["alive"])


def kept_gap(pre: dict, post: dict, ref: dict) -> float:
    """The largest gap, over every field the round writes, between the
    program's state after the round and the reference's, relative to the
    field's largest magnitude before or after (so a field reset to zero
    reads 1 where it was not): the split positions excepted."""
    want = ref["state"]
    moved = ref["split"].clone()
    moved[ref["target"][ref["split"]]] = True
    worst = 0.0
    for f, a, b, p in _fields(post, want, pre):
        if f == "means":
            keep = ~moved
            a, b, p = a[keep], b[keep], p[keep]
        if a.numel() == 0:
            continue
        scale = max(float(b.abs().max()), float(p.abs().max()), 1e-30)
        worst = max(worst, float((a.float() - b.float()).abs().max()) / scale)
    return worst


def _fields(post: dict, want: dict, pre: dict):
    for f in PARAMS + STATS:
        yield f, post[f], want[f], pre[f]
    for m in ("mu", "nu"):
        for f in PARAMS:
            yield f"{m}.{f}", post[m][f], want[m][f], pre[m][f]


def compare(pre: dict, post: dict, ref: dict) -> dict:
    """The round's readings: ``decision_mismatch`` (slots whose alive,
    granted, split or pruned state differs from the reference's),
    ``kept_gap`` (:func:`kept_gap`) and the split draws' statistics
    (:func:`noise_readings`)."""
    got = decisions(pre, post)
    want = dict(alive=ref["state"]["alive"], is_target=ref["is_target"], split=ref["split"],
                pruned=ref["pruned"])
    bad = torch.zeros_like(pre["alive"])
    for k in want:
        bad |= got[k] != want[k]
    return dict(decision_mismatch=float(bad.sum()), kept_gap=kept_gap(pre, post, ref),
                **noise_readings(*split_noise(pre, post, ref)))
