"""Sharded rendering and training over a ("data", "tile") process mesh
(counterpart of ``tpusplat/parallel/sharded.py``).

  * Gaussians are sharded over ``tile`` for preprocess: rank (d, t) holds
    rows [t N/T, (t+1) N/T) of every parameter, the same on every ``data``
    rank (:func:`shard_params`).
  * The screen attributes are gathered over ``tile`` (as one [N, 16]
    exchange table), and the image's tile rows are split over the same
    axis: each rank bins and blends only its strip of ``nrows`` tile rows.
    The backward either reduce-scatters the dense attribute gradients
    (``grad_exchange="dense"``) or runs the compact all-to-all exchange of
    :mod:`tpusplat_torch.parallel.compact_grad` (``"compact"``, when strip
    compaction is on).
  * Cameras are split over ``data``; parameter gradients are summed over it.

Each process passes the whole camera batch (and target batch) and its own
parameter shard; it renders its data slice of the batch. Counters are
summed over the whole mesh before the update, so every rank takes the same
gate decision and the shards stay consistent.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusplat_torch.config import RenderConfig
from tpusplat_torch.ops.binning import bin_and_sort
from tpusplat_torch.ops.preprocess import preprocess
from tpusplat_torch.ops.rasterize import rasterize
from tpusplat_torch.parallel.collectives import (
    gather_chunks, all_gather, all_reduce_, gather_strips, halo_exchange, ring_all_reduce,
)
from tpusplat_torch.parallel.compact_grad import (
    CompactStatic, exchange_render, pack_exchange_table, pg_from_table,
)
from tpusplat_torch.parallel.mesh import RenderMesh
from tpusplat_torch.train.losses import gs_loss, ssim_map
from tpusplat_torch.train.step import (
    Optimizer, TrainState, adam_update, merge_trainable, split_trainable,
)
from tpusplat_torch.types import Camera, GaussianParams

COUNTERS = ("capacity_overflow", "tile_overflow", "gauss_overflow", "a2a_overflow")
_SSIM_HALO = 5  # 11x11 window: 5 context rows on each side


def rows_per_shard(height: int, cfg: RenderConfig, n_tile_shards: int) -> int:
    """Tile rows of one strip."""
    tiles_y = (height + cfg.tile_h - 1) // cfg.tile_h
    return -(-tiles_y // n_tile_shards)


def _rows(n: int, mesh: RenderMesh) -> slice:
    if n % mesh.tile:
        raise ValueError(f"{n} Gaussians do not split evenly over {mesh.tile} tile shards "
                         "(pad with dead Gaussians)")
    k = n // mesh.tile
    return slice(mesh.t * k, (mesh.t + 1) * k)


def shard_params(params: GaussianParams, mesh: RenderMesh) -> GaussianParams:
    """This rank's shard of the parameters (the counterpart of
    ``params_sharding``): rows [t N/T, (t+1) N/T)."""
    sl = _rows(params.num_gaussians, mesh)
    return GaussianParams(**{f.name: getattr(params, f.name)[sl]
                             for f in dataclasses.fields(params)})


def shard_state(state: TrainState, mesh: RenderMesh) -> TrainState:
    """This rank's shard of a train state: every per-Gaussian tensor cut as
    :func:`shard_params` cuts the parameters."""
    sl = _rows(state.params.num_gaussians, mesh)
    return TrainState(
        params=shard_params(state.params, mesh),
        mu={k: v[sl] for k, v in state.mu.items()}, nu={k: v[sl] for k, v in state.nu.items()},
        count=state.count, step=state.step, grad_accum=state.grad_accum[sl],
        grad_count=state.grad_count[sl], max_radii=state.max_radii[sl])


def _gather_rows(x: torch.Tensor, mesh: RenderMesh) -> torch.Tensor:
    return torch.cat(gather_chunks(x, mesh.tile_group), dim=0)


def gather_params(params: GaussianParams, mesh: RenderMesh) -> GaussianParams:
    """The whole parameter set from the shards (every tile rank calls it)."""
    return GaussianParams(**{f.name: _gather_rows(getattr(params, f.name), mesh)
                             for f in dataclasses.fields(params)})


def gather_state(state: TrainState, mesh: RenderMesh) -> TrainState:
    """The whole train state from the shards (every tile rank calls it)."""
    return TrainState(
        params=gather_params(state.params, mesh),
        mu={k: _gather_rows(v, mesh) for k, v in state.mu.items()},
        nu={k: _gather_rows(v, mesh) for k, v in state.nu.items()},
        count=state.count, step=state.step, grad_accum=_gather_rows(state.grad_accum, mesh),
        grad_count=_gather_rows(state.grad_count, mesh),
        max_radii=_gather_rows(state.max_radii, mesh))


def local_batch(batch, mesh: RenderMesh):
    """This rank's data slice of a batch (a list of cameras or a tensor)."""
    b = len(batch)
    if b % mesh.data:
        raise ValueError(f"a batch of {b} does not split over {mesh.data} data ranks")
    k = b // mesh.data
    return batch[mesh.d * k:(mesh.d + 1) * k]


def _shard_render(params: GaussianParams, cams: list[Camera], cfg: RenderConfig,
                  mesh: RenderMesh, nrows: int, cap_shard: int):
    """This rank's strips of its local cameras (``_shard_render_body`` of
    the JAX package). Returns (strips [B_local, nrows * tile_h, W, 3],
    counters [4] int32 summed over the local cameras, in ``COUNTERS``
    order)."""
    width, height = cams[0].width, cams[0].height
    row0 = mesh.t * nrows
    tiles_x, tiles_y = cfg.tile_grid(width, height)
    n_local = params.num_gaussians
    n_total = n_local * mesh.tile
    gcap = cfg.strip_gauss_capacity(n_total, nrows, tiles_y)
    tables = torch.stack([pack_exchange_table(preprocess(params, cam, cfg)) for cam in cams])

    if (cfg.grad_exchange == "compact" and gcap is not None and mesh.tile > 1
            and nrows < tiles_y):
        st = CompactStatic(cfg=cfg, width=width, height=height, nrows=nrows,
                           cap_shard=cap_shard, gcap=gcap, n_total=n_total, n_local=n_local,
                           n_shards=mesh.tile)
        strips, counters = exchange_render(tables, st, mesh.tile_group, row0)
        return strips, counters.sum(0).to(torch.int32)

    # Dense exchange: gather the table; its backward reduce-scatters.
    full = all_gather(tables, mesh.tile_group, dim=1)
    strips, counters = [], []
    for tbl in full:
        pg = pg_from_table(tbl)
        binned = bin_and_sort(pg, width, height, cfg, row0, nrows, cap_shard,
                              gauss_capacity=gcap)
        img, aux = rasterize(pg, binned, width, height, cfg, row0, nrows)
        strips.append(img)
        zero = torch.zeros_like(aux["gauss_overflow"])
        counters.append(torch.stack([aux["capacity_overflow"], aux["tile_overflow"],
                                     aux["gauss_overflow"], zero]))
    return torch.stack(strips), torch.stack(counters).sum(0).to(torch.int32)


def strip_geometry(n_local: int, height: int, cfg: RenderConfig, n_tile_shards: int):
    """(nrows, cap_shard): tile rows of a strip, instance capacity of a
    strip (sized on the shard's Gaussian count ``n_local``, as in the JAX
    package)."""
    return rows_per_shard(height, cfg, n_tile_shards), cfg.instance_capacity(max(n_local, 1))


def render_sharded(params: GaussianParams, cameras: list[Camera], cfg: RenderConfig,
                   mesh: RenderMesh):
    """Render a batch of cameras over the mesh.

    ``params`` is this rank's shard (:func:`shard_params`); ``cameras`` the
    whole batch, its length a multiple of the ``data`` size. Returns (this
    rank's data slice of the images [B / data, H, W, 3], gathered over
    ``tile`` and differentiable; this rank's counters, a dict of 0-d int32
    over ``COUNTERS``, summed over its cameras)."""
    cams = local_batch(cameras, mesh)
    nrows, cap_shard = strip_geometry(params.num_gaussians, cams[0].height, cfg, mesh.tile)
    strips, counters = _shard_render(params, cams, cfg, mesh, nrows, cap_shard)
    imgs = gather_strips(strips, mesh.tile_group, dim=1)[:, :cams[0].height]
    return imgs, dict(zip(COUNTERS, counters.unbind(0)))


def _strip_loss_local(strips, targets, row0_px: int, total_rows_px: int, height: int,
                      width: int, ssim_weight: float, mesh: RenderMesh):
    """This strip's exact share of the whole batch's ``gs_loss`` without
    its constant ``ssim_weight`` (``sharded.py:159-210`` of the JAX
    package). The SSIM window needs _SSIM_HALO rows of context across strip
    boundaries, exchanged with the neighbouring tile ranks; rows past the
    image are zeroed, which reproduces the image's zero padding, and the
    chain's ends receive zeros, which are that padding. The sum over the
    mesh, plus ``ssim_weight``, is the loss of the gathered images up to
    the order of the adds."""
    b, sh, _, c = strips.shape
    img = strips[:, :, :width]
    rows_abs = row0_px + torch.arange(sh, device=img.device)
    valid = (rows_abs < height).to(img.dtype)
    img = img * valid[None, :, None, None]
    top, bot = halo_exchange(img, mesh.tile_group, _SSIM_HALO)
    ext_img = torch.cat([top, img, bot], dim=1)
    tpad = torch.nn.functional.pad(
        targets, (0, 0, 0, 0, _SSIM_HALO, total_rows_px + _SSIM_HALO - height))
    ext_tgt = tpad[:, row0_px:row0_px + sh + 2 * _SSIM_HALO]
    l1_sum = torch.sum(torch.abs(img - ext_tgt[:, _SSIM_HALO:_SSIM_HALO + sh]))
    smap = ssim_map(ext_img, ext_tgt)[:, _SSIM_HALO:_SSIM_HALO + sh]
    ssim_sum = torch.sum(smap * valid[None, :, None, None])
    n_total = mesh.data * b * height * width * c
    return ((1.0 - ssim_weight) * l1_sum - ssim_weight * ssim_sum) / n_total


def _leaves(state: TrainState):
    trainable, alive = split_trainable(state.params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in trainable.items()}
    return trainable, alive, leaves


def _gated_update(state: TrainState, trainable: dict, alive, grads: dict, loss,
                  counters: torch.Tensor, optimizer: Optimizer):
    """Adam on this rank's shard, a no-op unless every counter summed over
    the mesh is 0 (``counters``: [4] int32, already summed). The densify
    statistics are left as they are, as the JAX package's sharded steps
    leave them."""
    with torch.no_grad():
        params, mu, nu, count = adam_update(optimizer, trainable, grads, state.mu, state.nu,
                                            state.count)
        ok = counters.sum() == 0

        def keep(new: dict, old: dict) -> dict:
            return {k: torch.where(ok, new[k], old[k]) for k in new}

        new_state = dataclasses.replace(
            state, params=merge_trainable(keep(params, trainable), alive),
            mu=keep(mu, state.mu), nu=keep(nu, state.nu), count=keep(count, state.count),
            step=state.step + ok.to(torch.int32))
    return new_state, dict(loss=loss, **dict(zip(COUNTERS, counters.unbind(0))))


def sharded_train_step(state: TrainState, cameras: list[Camera], targets: torch.Tensor,
                       cfg: RenderConfig, optimizer: Optimizer, mesh: RenderMesh,
                       ssim_weight: float = 0.2):
    """One optimizer step on a camera batch over the mesh.

    ``state`` holds this rank's shard (:func:`shard_state`); ``cameras``
    and ``targets`` [B, H, W, 3] the whole batch. Each rank takes the loss
    of its data slice's gathered images, scaled by B_local / B; parameter
    gradients are summed over ``data``; the counters over the whole mesh.
    Returns (state, metrics): the loss of the whole batch and the four
    overflow counters, 0-d tensors equal on every rank."""
    trainable, alive, leaves = _leaves(state)
    imgs, counters = render_sharded(merge_trainable(leaves, alive), cameras, cfg, mesh)
    tgt = local_batch(targets, mesh)
    loss_local = gs_loss(imgs, tgt, ssim_weight) * (len(tgt) / len(targets))
    grads = dict(zip(leaves, torch.autograd.grad(loss_local, list(leaves.values()))))
    for g in grads.values():
        all_reduce_(g, mesh.data_group)
    loss = all_reduce_(loss_local.detach().clone(), mesh.data_group)
    total = all_reduce_(torch.stack(list(counters.values())), mesh.world_group)
    return _gated_update(state, trainable, alive, grads, loss, total, optimizer)


def sharded_train_step_overlap(state: TrainState, cameras: list[Camera], targets: torch.Tensor,
                               cfg: RenderConfig, optimizer: Optimizer, mesh: RenderMesh,
                               ssim_weight: float = 0.2, grad_reduce: str = "ring"):
    """The overlap-ready step (``sharded_train_step_overlap`` of the JAX
    package): each rank takes its strip's exact share of the loss with the
    halo-exchange SSIM (:func:`_strip_loss_local`), so no image is
    gathered, and the parameter gradients are summed over ``data`` by
    :func:`ring_all_reduce` (``grad_reduce="ring"``) or one ``all_reduce``
    per tensor (``"psum"``). Same loss, update and gate as
    :func:`sharded_train_step` up to the order of the adds."""
    if grad_reduce not in ("ring", "psum"):
        raise ValueError(f"grad_reduce must be 'ring' or 'psum', got {grad_reduce!r}")
    trainable, alive, leaves = _leaves(state)
    cams, tgt = local_batch(cameras, mesh), local_batch(targets, mesh)
    width, height = cams[0].width, cams[0].height
    nrows, cap_shard = strip_geometry(state.params.num_gaussians, height, cfg, mesh.tile)
    strips, counters = _shard_render(merge_trainable(leaves, alive), cams, cfg, mesh, nrows,
                                     cap_shard)
    row0_px = mesh.t * nrows * cfg.tile_h
    loss_local = _strip_loss_local(strips, tgt, row0_px, mesh.tile * nrows * cfg.tile_h,
                                   height, width, ssim_weight, mesh)
    grads = dict(zip(leaves, torch.autograd.grad(loss_local, list(leaves.values()))))
    if grad_reduce == "ring":
        grads = ring_all_reduce(grads, mesh.data_group)
    else:
        for g in grads.values():
            all_reduce_(g, mesh.data_group)
    loss = all_reduce_(loss_local.detach().clone(), mesh.world_group) + ssim_weight
    total = all_reduce_(counters.clone(), mesh.world_group)
    return _gated_update(state, trainable, alive, grads, loss, total, optimizer)
