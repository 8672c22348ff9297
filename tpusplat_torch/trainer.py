"""Training CLI of the port (counterpart of ``apps/train.py``).

Fits a model to a capture, with densification, opacity resets, a PSNR /
SSIM eval, a final ``.ply`` and an optional checkpoint. Progress goes to
stderr as JSON lines.

    python -m tpusplat_torch.trainer --data CAPTURE --holdout 8 --ckpt state.npz \
        --out scene.ply
    python -m tpusplat_torch.trainer --synthetic --steps 500 --out scene.ply

``--data`` reads a COLMAP capture in the Mip-NeRF 360 layout (``sparse/0``
and ``images/``; the SfM points seed the model), a NeRF-synthetic
``transforms_train.json``, or a directory of ``.npz`` views; without it,
the targets are renders of a synthetic scene. ``--holdout K`` evaluates on
every Kth view and trains on the rest. ``--watchdog-secs`` exits with code
42 and every thread's stack when no step completes for that long.

The flags are those of ``apps/train.py`` plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path) and ``--dist-init``;
``--xla`` is refused (the port routes by tensor device: a CPU tensor takes
the plain path). ``--ckpt`` takes the ``.npz`` form only. ``TPUSPLAT_*``
environment variables apply under the flags.

``--mesh DATAxTILE`` trains over the tile-sharded path
(:mod:`tpusplat_torch.parallel.sharded`), one process per rank, each step on
DATA cameras; ``--overlap`` takes the overlap-ready step. Launch it as
``torchrun --nproc-per-node=DATA*TILE -m tpusplat_torch.trainer --mesh
DATAxTILE ...``: each process reads its rank from the environment (NCCL
with a card each; ``--device cpu`` uses gloo). Rank 0 logs and writes the
``.ply`` and the checkpoint, which holds the whole state gathered from the
shards. The eval renders the whole frame with the whole frame's instance
capacity, not a shard's.

The eval's frames are exact: it regrows the capacity as ``render_auto``
does, where ``apps/train.py`` evaluates a truncated frame until the
training steps have regrown it.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time

def main(argv=None) -> dict:
    """Run the trainer. Returns a summary: the logged ``losses`` as
    (step, loss) pairs, the ``evals`` (unrounded), the final ``step``, the
    final ``state`` (this rank's shard under ``--mesh``) and the render
    ``cfg`` its capacity regrows reached."""
    p = argparse.ArgumentParser("tpusplat_torch.trainer", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default=None,
                   help="capture directory: COLMAP (sparse/0 + images/), NeRF-synthetic "
                        "(transforms_train.json) or .npz views")
    p.add_argument("--synthetic", action="store_true",
                   help="fit renders of a synthetic scene (the default without --data)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--n-init", type=int, default=5000, help="initial gaussians")
    p.add_argument("--capacity", type=int, default=0,
                   help="slot capacity (0 = 4x the initial Gaussians: --n-init or the "
                        "SfM points)")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--sh-degree", type=int, default=2)
    p.add_argument("--cameras", type=int, default=16)
    p.add_argument("--densify-every", type=int, default=200)
    p.add_argument("--densify-until", type=int, default=0, help="0 = steps//2")
    p.add_argument("--opacity-reset-every", type=int, default=1500)
    p.add_argument("--holdout", type=int, default=0,
                   help="hold out every Kth view from training for the PSNR/SSIM eval "
                        "(K >= 2; 0 = eval on the training views)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="log eval PSNR/SSIM every N steps (0 = final only)")
    p.add_argument("--out", default="trained.ply")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint path (.npz): the whole train state, written at the end")
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
    p.add_argument("--watchdog-secs", type=float, default=0.0,
                   help="stall detector: exit(42) with stack dumps if no step completes "
                        "for this long (0 = off); must exceed the first step's time")
    p.add_argument("--xla", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    # Argument checks up front, before any data is read.
    if args.xla:
        p.error("--xla is not ported: tpusplat_torch routes by tensor device "
                "(--device cpu takes the plain path)")
    if args.holdout == 1:
        p.error("--holdout must be >= 2 (1 would hold out every view)")
    if args.ckpt is not None and not args.ckpt.endswith(".npz"):
        p.error("--ckpt takes a .npz path (the directory form is Orbax, a JAX library)")
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

    from tpusplat_torch.config import RenderConfig, regrow
    from tpusplat_torch.io.ply import save_ply
    from tpusplat_torch.io.synthetic import random_scene
    from tpusplat_torch.parallel import sharded
    from tpusplat_torch.parallel.collectives import all_reduce_
    from tpusplat_torch.render import render_auto
    from tpusplat_torch.train.checkpoint import save_checkpoint
    from tpusplat_torch.train.densify import DensifyConfig, densify_and_prune, reset_opacity
    from tpusplat_torch.train.losses import psnr, ssim
    from tpusplat_torch.train.step import create_train_state, make_optimizer, train_step
    from tpusplat_torch.train.watchdog import Watchdog

    lead = mesh is None or mesh.rank == 0
    tile = 1 if mesh is None else mesh.tile

    def _log(**kw):
        if lead:
            print(json.dumps(kw), file=sys.stderr, flush=True)

    cfg = dataclasses.replace(RenderConfig(max_per_tile=2048).with_env_overrides(),
                              sh_degree=args.sh_degree)
    cams, targets, colmap_init, scene_extent = _load_data(args, dev, cfg)

    # --- init model: the SfM points or n_init random Gaussians alive, free
    # slots up to the capacity ---
    init = random_scene(_capacity(args, colmap_init, tile), seed=1, sh_degree=args.sh_degree,
                        extent=3.0, scale_range=(0.05, 0.25), device=dev)
    cap = init.num_gaussians
    alive = torch.zeros(cap, dtype=torch.bool, device=dev)
    if colmap_init is None:
        alive[: args.n_init] = True
        init = dataclasses.replace(init, alive=alive)
    else:
        # The SfM cloud seeds the first slots (the 3DGS recipe); the random
        # dead slots after it leave room to densify.
        m = min(colmap_init.num_gaussians, cap)
        alive[:m] = True
        k_sh = init.sh.shape[1]  # this run's coefficient count
        seeded = {}
        for f in ("means", "log_scales", "quats", "opacities", "sh"):
            out = getattr(init, f).clone()
            v = getattr(colmap_init, f)
            out[:m] = v[:m, :k_sh] if out.dim() == 3 else v[:m]
            seeded[f] = out
        init = dataclasses.replace(init, alive=alive, **seeded)
        _log(colmap_points=colmap_init.num_gaussians, seeded=m, capacity=cap)
        del colmap_init

    # --- held-out eval split: every Kth view (the llffhold convention) ---
    eval_cams, eval_targets = cams, targets
    if args.holdout > 0 and len(cams) > args.holdout:
        hold = set(range(0, len(cams), args.holdout))
        eval_cams = [c for i, c in enumerate(cams) if i in hold]
        eval_targets = [t for i, t in enumerate(targets) if i in hold]
        cams = [c for i, c in enumerate(cams) if i not in hold]
        targets = [t for i, t in enumerate(targets) if i not in hold]
    held_out = eval_cams is not cams

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
    # The split draws come from numpy on the host, so that a run on the
    # card and one on the CPU densify alike, as every rank does.
    rng = np.random.default_rng(0)

    def densify(st):
        draws = [torch.from_numpy(rng.standard_normal((st.params.num_gaussians, 3),
                                                      dtype=np.float32)).to(dev)
                 for _ in range(2)]
        return densify_and_prune(st, None, dcfg, scene_extent, *draws)

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
    # Stall detection: a hung kernel or a dead collective becomes exit(42)
    # with every thread's stack, not a silent hang.
    dog = Watchdog(args.watchdog_secs).start() if args.watchdog_secs > 0 else None

    def poll_oldest():
        nonlocal cfg, done
        i, metrics = inflight.popleft()
        overflow = int(metrics["capacity_overflow"])
        if dog is not None:
            dog.beat(done)  # the counter read above waited for the step
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
        # Exact frames (render_auto regrows), at the whole frame's capacity:
        # under --mesh the training cfg's capacity was sized for one shard's
        # Gaussians.
        eval_cfg = cfg if mesh is None else dataclasses.replace(cfg, capacity=None)
        ps, ss, overflow = [], [], 0
        with torch.no_grad():
            for cam_e, tgt_e in zip(eval_cams, eval_targets):
                img, aux, eval_cfg = render_auto(params, cam_e, eval_cfg)
                overflow += int(aux["capacity_overflow"])
                ps.append(float(psnr(img, tgt_e)))
                ss.append(float(ssim(img, tgt_e, crop_border=True)))
        ev = dict(eval_step=step_no, psnr=sum(ps) / len(ps), ssim=sum(ss) / len(ss),
                  views=len(ps), holdout=held_out, final=final,
                  capacity=eval_cfg.instance_capacity(params.num_gaussians),
                  overflow=overflow)
        summary["evals"].append(ev)
        _log(**{**ev, "psnr": round(ev["psnr"], 2), "ssim": round(ev["ssim"], 4)})

    try:
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
            if dog is not None:
                # Work submitted: the completion beat in poll_oldest comes one
                # step later, and the first step builds the kernels.
                dog.beat(done)
            if mesh is None:
                state, metrics = train_step(state, cams[i], targets[i], cfg, optimizer)
            else:
                state, metrics = shard_step(state, [cams[j] for j in i],
                                            torch.stack([targets[j] for j in i]), cfg,
                                            optimizer, mesh)
            inflight.append((i, metrics))
            if len(inflight) >= 2 or done + len(inflight) >= args.steps:
                poll_oldest()
            step = done
            if args.densify_every and step - last_densify >= args.densify_every \
                    and step <= densify_until:
                last_densify = step
                if mesh is None:
                    state = densify(state)
                else:  # on the whole state, the same draws on every rank
                    whole = densify(sharded.gather_state(state, mesh))
                    state = sharded.shard_state(whole, mesh)
            if args.opacity_reset_every and step - last_reset >= args.opacity_reset_every \
                    and step <= densify_until:
                last_reset = step
                state = reset_opacity(state)
            if args.eval_every and step - last_eval >= args.eval_every:
                last_eval = step
                run_eval(step)
        while inflight:
            poll_oldest()
    finally:  # a run that raises leaves no watchdog behind to kill its process
        if dog is not None:
            dog.stop()
    run_eval(done, final=True)

    params = whole_params()
    if lead:
        save_ply(args.out, params)
        print(f"saved {args.out}", file=sys.stderr)
    if args.ckpt:
        whole = state if mesh is None else sharded.gather_state(state, mesh)
        if lead:
            save_checkpoint(args.ckpt, whole)
            print(f"checkpointed {args.ckpt}", file=sys.stderr)
    summary.update(step=int(state.step), state=state, cfg=cfg)
    return summary


def _capacity(args, colmap_init, tile: int) -> int:
    """The slot capacity: ``--capacity``, else 4x the SfM points or
    ``--n-init``, rounded up to even Gaussian shards over the tile axis."""
    n = args.n_init if colmap_init is None else colmap_init.num_gaussians
    cap = args.capacity or 4 * n
    return -(-cap // tile) * tile


def _load_data(args, dev, cfg):
    """(cameras, target images on ``dev``, the SfM-seeded parameters or
    None, the scene extent) of ``--data``, or of a synthetic scene."""
    import numpy as np
    import torch

    from tpusplat_torch.io import dataset

    if args.data is None:
        return (*_synthetic_views(args, dev, cfg), None, 6.0)
    colmap_init = None
    if dataset.is_colmap(args.data):
        from tpusplat_torch.io.colmap import load_colmap_scene

        cams, names, colmap_init = load_colmap_scene(args.data, device=dev)
        imgs = [dataset.read_image(os.path.join(args.data, "images", nm))[..., :3]
                for nm in names]
    elif dataset.is_nerf_synthetic(args.data):
        cams, imgs = dataset.load_nerf_synthetic(args.data, device=dev)
    else:
        cams, imgs = dataset.load_views(args.data, device=dev)
    if not cams:
        raise SystemExit(f"tpusplat_torch.trainer: no views in {args.data}")
    targets = [torch.as_tensor(np.ascontiguousarray(im, np.float32)).to(dev) for im in imgs]
    # The scene extent, 1.1x the radius of the camera centres' bounding
    # sphere (the 3DGS "nerf normalization"), scales the means' learning
    # rate and the densification thresholds.
    centers = np.stack([c.cam_pos.cpu().numpy() for c in cams])
    radius = float(np.max(np.linalg.norm(centers - centers.mean(axis=0), axis=1)))
    return cams, targets, colmap_init, max(radius * 1.1, 1.0)


def _synthetic_views(args, dev, cfg):
    """Renders of a synthetic ground-truth scene from a ring of cameras."""
    import numpy as np
    import torch

    from tpusplat_torch.camera import look_at_camera
    from tpusplat_torch.io.synthetic import random_scene
    from tpusplat_torch.render import render_stages

    gt = random_scene(8000, seed=42, sh_degree=args.sh_degree, scale_range=(0.05, 0.2),
                      device=dev)
    rng = np.random.default_rng(0)
    cams, targets = [], []
    with torch.no_grad():
        for i in range(args.cameras):
            ang = 2 * np.pi * i / args.cameras
            eye = [6 * np.sin(ang), rng.uniform(-1, 1), 6 * np.cos(ang)]
            cam = look_at_camera(eye, [0, 0, 0], args.width, args.height, fov_deg=60.0,
                                 device=dev)
            img, _ = render_stages(gt, cam, cfg)
            cams.append(cam)
            targets.append(img)
    return cams, targets


if __name__ == "__main__":
    main()
