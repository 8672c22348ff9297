"""Multi-process dryrun (counterpart of ``tpusplat/parallel/dryrun.py``): one
full sharded training step on an n-rank mesh at tiny shapes, each rank a
process started by :func:`tpusplat_torch.parallel.launch.spawn`.

It certifies the path the CLIs' ``--mesh`` runs: the sharded render is
asserted equal to the one-process render (not merely a finite loss), the
monolithic and overlap steps agree, and the compact gradient exchange
agrees with the dense one. The JAX dryrun runs its blocks once with the
Pallas and once with the XLA rasterizer; here the device picks the route:
on the card the CUDA kernels, on the CPU their plain versions.

    python -m tpusplat_torch.parallel.dryrun 4                  # 4 cards, NCCL
    python -m tpusplat_torch.parallel.dryrun 4 --device cuda:0 --backend gloo
    python -m tpusplat_torch.parallel.dryrun 3 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import tempfile

import numpy as np
import torch


def mesh_dims(n_ranks: int) -> tuple[int, int]:
    """(data, tile) as the JAX dryrun lays out n devices: data = 2 when n
    is even, else 1."""
    data = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    return data, n_ranks // data


def compact_geometry(tile: int) -> tuple[int, int, int, int]:
    """(width, height, strip_gauss_margin_rows, capacity_mult) of the
    compact block. The JAX block's frame (64 x 64 tile pixels: 4 tile rows a
    shard), margin (4 rows) and capacity (16 N) turn strip compaction on
    only from 4 tile shards up: with fewer, the margin alone makes a strip's
    stream cap reach N, and with 3 the middle strip holds the whole scene.
    Below 4 shards the frame is 128 x 128, over which the scene spans every
    strip, with no margin rows and twice the capacity (the square frame's
    Gaussians cover more tiles)."""
    if tile >= 4:
        return 64, 16 * 4 * tile, 4, 16
    return 128, 128, 0, 32


def _scene(n, seed, width, height, batch, device):
    from tpusplat_torch.camera import look_at_camera
    from tpusplat_torch.io.synthetic import random_scene

    params = random_scene(n, seed=seed, sh_degree=1, scale_range=(0.1, 0.5), device=device)
    cams = [look_at_camera([np.sin(i), 0.3, 5.0], [0, 0, 0], width, height, fov_deg=60.0,
                           device=device) for i in range(batch)]
    return params, cams


def _check(cond, msg):
    if not cond:
        raise AssertionError(f"dryrun: {msg}")


def _rank(rank, dev, n_ranks):
    """One rank: the four blocks of the JAX dryrun on this rank's shard."""
    from tpusplat_torch.config import RenderConfig
    from tpusplat_torch.parallel.mesh import make_render_mesh
    from tpusplat_torch.parallel.sharded import (
        local_batch, pad_params, render_sharded, shard_params, shard_state,
        sharded_train_step, sharded_train_step_overlap,
    )
    from tpusplat_torch.render import render_stages
    from tpusplat_torch.train.step import create_train_state, make_optimizer

    data, tile = mesh_dims(n_ranks)
    mesh = make_render_mesh(data, tile)
    route = "cuda" if dev.type == "cuda" else "plain"
    n_gauss, width, height, batch = 128 * tile, 64, 16 * tile, data
    cfg = RenderConfig(sh_degree=1, max_per_tile=2048, tile_chunk=4, gauss_chunk=16,
                       capacity_mult=16)
    params, cams = _scene(n_gauss, 0, width, height, batch, dev)
    rng = np.random.default_rng(0)
    targets = torch.tensor(rng.uniform(0, 1, (batch, height, width, 3)), dtype=torch.float32,
                           device=dev)

    # 1. The sharded render equals the one-process render (the keystone: it
    #    certifies the collective layout, not just liveness).
    with torch.no_grad():
        imgs, counters = render_sharded(shard_params(params, mesh), cams, cfg, mesh)
        for name, v in counters.items():
            _check(int(v) == 0, f"{route}: {name} {int(v)} in the sharded render")
        for b, cam in enumerate(local_batch(cams, mesh)):
            ref, _ = render_stages(params, cam, cfg)
            err = (imgs[b] - ref).abs()
            _check(bool((err <= 1e-5 + 1e-4 * ref.abs()).all()),
                   f"{route}: sharded != one-process render (camera {mesh.d * len(imgs) + b}, "
                   f"max abs err {float(err.max())})")

    # 2. One full sharded training step with a finite loss.
    opt = make_optimizer()
    state = shard_state(create_train_state(params), mesh)
    _, metrics = sharded_train_step(state, cams, targets, cfg, opt, mesh)
    loss = float(metrics["loss"])
    _check(math.isfinite(loss), f"{route}: loss not finite: {loss}")

    # 3. The overlap step (halo-exchange strip loss, ring gradient sum)
    #    matches the monolithic step's loss.
    _, metrics2 = sharded_train_step_overlap(state, cams, targets, cfg, opt, mesh)
    loss_ov = float(metrics2["loss"])
    _check(math.isfinite(loss_ov), f"{route}: overlap loss not finite")
    _check(abs(loss_ov - loss) <= 1e-4 * max(1.0, abs(loss)),
           f"{route}: overlap step loss {loss_ov} != monolithic {loss}")
    if rank == 0:
        print(f"dryrun({n_ranks}): mesh=({data}x{tile}) route={route} loss={loss:.4f} "
              f"overlap_loss={loss_ov:.4f} image-equality OK", flush=True)

    # 4. The compact gradient exchange against the dense one on the same
    #    mesh, on a scene where strip compaction is on.
    width_c, height_c, margin, mult = compact_geometry(tile)
    cfg_c = dataclasses.replace(cfg, strip_gauss_mult=1.5, strip_gauss_margin_rows=margin,
                                capacity_mult=mult)
    params_c, cams_c = _scene(4096, 1, width_c, height_c, batch, dev)
    params_c = pad_params(params_c, tile)
    tiles_y = cfg_c.tile_grid(width_c, height_c)[1]
    _check(cfg_c.strip_gauss_capacity(params_c.num_gaussians, -(-tiles_y // tile), tiles_y)
           is not None, "the compact block no longer activates compaction")
    targets_c = torch.tensor(rng.uniform(0, 1, (batch, height_c, width_c, 3)),
                             dtype=torch.float32, device=dev)
    out = {}
    for mode in ("compact", "dense"):
        st = shard_state(create_train_state(params_c), mesh)
        st, mm = sharded_train_step(st, cams_c, targets_c,
                                    dataclasses.replace(cfg_c, grad_exchange=mode), opt, mesh)
        for name in ("capacity_overflow", "gauss_overflow", "a2a_overflow"):
            _check(int(mm[name]) == 0, f"{route} {mode}: {name} {int(mm[name])}")
        _check(int(st.step) == 1, f"{route} {mode}: step gated")
        out[mode] = (float(mm["loss"]), st.params.means, st.mu)
    _check(abs(out["compact"][0] - out["dense"][0]) <= 1e-5 * max(1.0, abs(out["dense"][0])),
           f"{route}: compact loss {out['compact'][0]} != dense {out['dense'][0]}")
    err = float((out["compact"][1] - out["dense"][1]).abs().max())
    _check(err <= 3e-6, f"{route}: compact-gradient exchange != dense exchange "
                        f"(means off by {err})")
    # Adam's first moments hold the summed gradient's magnitude, which the
    # first update (-lr sign(g)) does not show.
    for k, mu in out["dense"][2].items():
        rel = float((out["compact"][2][k] - mu).abs().max() / (mu.abs().max() + 1e-30))
        _check(rel <= 1e-5, f"{route}: compact != dense exchange: Adam's mu[{k}] off by "
                            f"{rel} of its largest")
    if rank == 0:
        print(f"dryrun({n_ranks}): compact-gradient all_to_all exchange == dense "
              f"reduce-scatter (loss {out['compact'][0]:.4f}, means within {err:.3g})",
              flush=True)
    if route == "cuda":
        launches = _kernel_launches()
        _check(all(launches.values()), f"a kernel of the path was not launched ({launches})")
        if rank == 0:
            print(f"dryrun({n_ranks}): rank 0 kernel launches {launches}", flush=True)


def _kernel_launches() -> dict:
    """This process's launch counters of the four kernels (all three modes
    of the segment reduce)."""
    from tpusplat_torch.ops import emission, rasterize
    from tpusplat_torch.ops import segment_reduce as sr

    return dict(emission=emission.LAUNCHES, forward_blend=rasterize.FORWARD_LAUNCHES,
                backward_blend=rasterize.BACKWARD_LAUNCHES, segment_reduce=sr.LAUNCHES,
                segment_reduce_targets=sr.TARGETS_LAUNCHES,
                segment_reduce_multirange=sr.MULTIRANGE_LAUNCHES)


def run_dryrun(n_ranks: int, device="cuda", backend: str | None = None) -> None:
    """One sharded training step on ``n_ranks`` processes (mesh as
    :func:`mesh_dims`), with the assertions of the JAX dryrun; raises if a
    rank fails. ``device`` and ``backend`` as
    :func:`tpusplat_torch.parallel.launch.spawn` takes them: "cuda" gives
    each rank a card and NCCL, "cuda:0" with ``backend="gloo"`` puts every
    rank on one card, "cpu" runs gloo on the CPU."""
    from tpusplat_torch.parallel.launch import spawn

    if mesh_dims(n_ranks)[1] < 2:
        raise ValueError(f"run_dryrun: {n_ranks} ranks give a mesh of {mesh_dims(n_ranks)}; "
                         "the compact-exchange block needs 2 tile shards or more")
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_rank, n_ranks, (n_ranks,), init_file=f"{tmp}/init", device=device,
              backend=backend)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("tpusplat_torch.parallel.dryrun", description=__doc__)
    p.add_argument("n_ranks", type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    run_dryrun(args.n_ranks, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
