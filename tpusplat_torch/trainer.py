"""Training CLI of the port (counterpart of ``apps/train.py``).

Fits a randomly initialised model to renders of a synthetic ground-truth
scene from a ring of cameras, with densification, opacity resets, a PSNR /
SSIM eval and a final ``.ply``. Progress goes to stderr as JSON lines.

    python -m tpusplat_torch.trainer --synthetic --steps 500 --out scene.ply

The flags are those of ``apps/train.py`` plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path) and ``--dist-init``. Not
ported yet, and rejected: ``--data``, ``--holdout``, ``--ckpt``,
``--watchdog-secs`` and ``--xla``. ``TPUSPLAT_*`` environment variables
apply under the flags.

``--mesh DATAxTILE`` trains over the tile-sharded path
(:mod:`tpusplat_torch.parallel.sharded`), one process per rank, each step on
DATA cameras; ``--overlap`` takes the overlap-ready step. Launch it as
``torchrun --nproc-per-node=DATA*TILE -m tpusplat_torch.trainer --mesh
DATAxTILE ...``: each process reads its rank from the environment (NCCL
with a card each; ``--device cpu`` uses gloo). Rank 0 logs and writes the
``.ply``. The eval renders the whole frame with the whole frame's instance
capacity, not a shard's.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time

# Flags of apps/train.py that the port does not take yet: those with a value
# and the switches.
UNPORTED = ("data", "holdout", "ckpt", "watchdog_secs")
UNPORTED_SWITCHES = ("xla",)


def main(argv=None) -> dict:
    """Run the trainer. Returns a summary: the logged ``losses`` as
    (step, loss) pairs, the ``evals`` and the final ``step``."""
    p = argparse.ArgumentParser("tpusplat_torch.trainer", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--synthetic", action="store_true",
                   help="fit renders of a synthetic scene (the only data source so far)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--n-init", type=int, default=5000, help="initial gaussians")
    p.add_argument("--capacity", type=int, default=0, help="slot capacity (0 = 4x n-init)")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--sh-degree", type=int, default=2)
    p.add_argument("--cameras", type=int, default=16)
    p.add_argument("--densify-every", type=int, default=200)
    p.add_argument("--densify-until", type=int, default=0, help="0 = steps//2")
    p.add_argument("--opacity-reset-every", type=int, default=1500)
    p.add_argument("--eval-every", type=int, default=0,
                   help="log eval PSNR/SSIM every N steps (0 = final only)")
    p.add_argument("--out", default="trained.ply")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--mesh", default=None,
                   help="'DATAxTILE' process mesh for tile-sharded training (e.g. 1x2): "
                        "cameras batch over DATA, Gaussians and image tile rows shard "
                        "over TILE; one process per rank (torchrun)")
    p.add_argument("--overlap", action="store_true",
                   help="with --mesh: the overlap-ready step (halo-exchange strip loss, "
                        "ring all-reduce)")
    p.add_argument("--dist-init", default="env://",
                   help="with --mesh: init method of the process group (env:// as "
                        "torchrun sets it, or file:///path); RANK and WORLD_SIZE come "
                        "from the environment")
    for flag in UNPORTED:
        p.add_argument("--" + flag.replace("_", "-"), default=None, help=argparse.SUPPRESS)
    for flag in UNPORTED_SWITCHES:
        p.add_argument("--" + flag, action="store_const", const=True, default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag in UNPORTED + UNPORTED_SWITCHES:
        if getattr(args, flag) is not None:
            p.error(f"--{flag.replace('_', '-')} is not ported to tpusplat_torch yet "
                    "(see ROADMAP.md); apps/train.py has it")
    from tpusplat_torch.parallel.mesh import mesh_dims_arg

    mesh_dims = mesh_dims_arg(p, args.mesh)
    if args.overlap and not mesh_dims:
        p.error("--overlap needs --mesh")

    import torch

    dev, mesh = torch.device(args.device), None
    if mesh_dims:
        from tpusplat_torch.parallel.mesh import make_render_mesh, multihost_initialize

        dev = multihost_initialize(args.device, init_method=args.dist_init)
    try:
        if mesh_dims:
            mesh = make_render_mesh(*mesh_dims)
        return _train(args, dev, mesh)
    finally:
        if mesh_dims:
            torch.distributed.destroy_process_group()


def _train(args, dev, mesh) -> dict:
    import numpy as np
    import torch

    from tpusplat_torch.camera import look_at_camera
    from tpusplat_torch.config import RenderConfig, regrow
    from tpusplat_torch.io.ply import save_ply
    from tpusplat_torch.io.synthetic import random_scene
    from tpusplat_torch.parallel import sharded
    from tpusplat_torch.parallel.collectives import all_reduce_
    from tpusplat_torch.render import render_auto, render_stages
    from tpusplat_torch.train.densify import DensifyConfig, densify_and_prune, reset_opacity
    from tpusplat_torch.train.losses import psnr, ssim
    from tpusplat_torch.train.step import create_train_state, make_optimizer, train_step

    lead = mesh is None or mesh.rank == 0
    tile = 1 if mesh is None else mesh.tile

    def _log(**kw):
        if lead:
            print(json.dumps(kw), file=sys.stderr, flush=True)

    w, h = args.width, args.height
    cfg = dataclasses.replace(RenderConfig(max_per_tile=2048).with_env_overrides(),
                              sh_degree=args.sh_degree)

    # --- data: ground-truth renders of a synthetic scene are the targets ---
    gt = random_scene(8000, seed=42, sh_degree=args.sh_degree, scale_range=(0.05, 0.2),
                      device=dev)
    rng = np.random.default_rng(0)
    cams, targets = [], []
    with torch.no_grad():
        for i in range(args.cameras):
            ang = 2 * np.pi * i / args.cameras
            eye = [6 * np.sin(ang), rng.uniform(-1, 1), 6 * np.cos(ang)]
            cam = look_at_camera(eye, [0, 0, 0], w, h, fov_deg=60.0, device=dev)
            img, _ = render_stages(gt, cam, cfg)
            cams.append(cam)
            targets.append(img)
    scene_extent = 6.0

    # --- init model: n_init live Gaussians, free slots up to the capacity ---
    cap = args.capacity or 4 * args.n_init
    cap = -(-cap // tile) * tile  # even Gaussian shards over the tile axis
    init = random_scene(cap, seed=1, sh_degree=args.sh_degree, extent=3.0,
                        scale_range=(0.05, 0.25), device=dev)
    alive = torch.zeros(cap, dtype=torch.bool, device=dev)
    alive[: args.n_init] = True
    init = dataclasses.replace(init, alive=alive)

    optimizer = make_optimizer(scene_extent=scene_extent, means_lr_max_steps=args.steps)
    state = create_train_state(init)
    if mesh is not None:
        state = sharded.shard_state(state, mesh)
        shard_step = (sharded.sharded_train_step_overlap if args.overlap
                      else sharded.sharded_train_step)
        _log(mesh=f"{mesh.data}x{mesh.tile}", overlap=bool(args.overlap),
             backend=torch.distributed.get_backend())
    dcfg = DensifyConfig()
    densify_until = args.densify_until or args.steps // 2
    gen = torch.Generator(device=dev).manual_seed(0)

    # Exact capacity recovery: train_step gates its update on the device, so
    # an overflowed step leaves the state as it was. The host reads the
    # counters one step late -- the read of step k overlaps step k+1 on the
    # card -- and queues the camera again at a grown capacity. No truncated
    # gradient is ever applied.
    t0 = time.time()
    inflight = collections.deque()  # (camera index, metrics) not yet read
    retry_q = collections.deque()  # cameras to retry after a regrow
    done, seq = 0, 0
    summary = dict(losses=[], evals=[])

    def poll_oldest():
        nonlocal cfg, done
        i, metrics = inflight.popleft()
        overflow = int(metrics["capacity_overflow"])
        # Per channel; the instance capacity on a shard's Gaussian count
        # (the sharded counters are summed over the mesh: every rank agrees).
        cfg2, changes = regrow(cfg, metrics, state.params.num_gaussians)
        if changes is not None:
            cfg = cfg2
            retry_q.append(i)
            _log(step=done + 1, **changes)
            return
        done += 1
        if done % args.log_every == 0:
            loss = float(metrics["loss"])
            summary["losses"].append((done, loss))
            alive = state.params.alive.sum()
            if mesh is not None:
                all_reduce_(alive, mesh.tile_group)
            _log(step=done, loss=round(loss, 5), alive=int(alive),
                 overflow=overflow, sps=round(done / (time.time() - t0), 2))

    def whole_params():
        return state.params if mesh is None else sharded.gather_params(state.params, mesh)

    def run_eval(step_no, final=False):
        params = whole_params()  # every rank gathers; rank 0 renders
        if not lead:
            return
        # The whole frame at the whole frame's capacity: under --mesh the
        # training cfg's capacity was sized for one shard's Gaussians.
        eval_cfg = cfg if mesh is None else dataclasses.replace(cfg, capacity=None)
        ps, ss, overflow = [], [], 0
        with torch.no_grad():
            for cam_e, tgt_e in zip(cams, targets):
                if mesh is None:
                    img, aux = render_stages(params, cam_e, eval_cfg)
                else:
                    img, aux, eval_cfg = render_auto(params, cam_e, eval_cfg)
                overflow += int(aux["capacity_overflow"])
                ps.append(float(psnr(img, tgt_e)))
                ss.append(float(ssim(img, tgt_e, crop_border=True)))
        ev = dict(eval_step=step_no, psnr=round(sum(ps) / len(ps), 2),
                  ssim=round(sum(ss) / len(ss), 4), views=len(ps), holdout=False,
                  final=final, capacity=eval_cfg.instance_capacity(params.num_gaussians),
                  overflow=overflow)
        summary["evals"].append(ev)
        _log(**ev)

    last_densify = last_reset = last_eval = 0
    if args.eval_every:
        run_eval(0)  # pre-training baseline
    while done < args.steps:
        if retry_q:
            i = retry_q.popleft()
        elif mesh is None:
            i = seq % len(cams)
            seq += 1
        else:  # one camera for each data rank
            i = tuple((seq + j) % len(cams) for j in range(mesh.data))
            seq += mesh.data
        if mesh is None:
            state, metrics = train_step(state, cams[i], targets[i], cfg, optimizer)
        else:
            state, metrics = shard_step(state, [cams[j] for j in i],
                                        torch.stack([targets[j] for j in i]), cfg, optimizer,
                                        mesh)
        inflight.append((i, metrics))
        if len(inflight) >= 2 or done + len(inflight) >= args.steps:
            poll_oldest()
        step = done
        if args.densify_every and step - last_densify >= args.densify_every \
                and step <= densify_until:
            last_densify = step
            if mesh is None:
                state = densify_and_prune(state, gen, dcfg, scene_extent)
            else:  # on the whole state, the same draws on every rank
                state = sharded.shard_state(densify_and_prune(
                    sharded.gather_state(state, mesh), gen, dcfg, scene_extent), mesh)
        if args.opacity_reset_every and step - last_reset >= args.opacity_reset_every \
                and step <= densify_until:
            last_reset = step
            state = reset_opacity(state)
        if args.eval_every and step - last_eval >= args.eval_every:
            last_eval = step
            run_eval(step)
    while inflight:
        poll_oldest()
    run_eval(done, final=True)

    params = whole_params()
    if lead:
        save_ply(args.out, params)
        print(f"saved {args.out}", file=sys.stderr)
    summary["step"] = int(state.step)
    return summary


if __name__ == "__main__":
    main()
