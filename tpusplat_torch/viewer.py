"""CLI renderer of the port (counterpart of ``apps/viewer.py``).

Renders one or more cameras to PNG files and prints one JSON line per frame
to stderr. Run as ``python -m tpusplat_torch.viewer test -w 1920 --height
1080 --orbit 3``. The flags are those of ``apps/viewer.py`` plus
``--device`` and ``--dist-init``, without ``--xla``: the port routes by
tensor device, and ``--device cpu`` runs the plain path. ``TPUSPLAT_*``
environment variables apply under the flags.

``-i/--interactive`` runs the keyboard-driven terminal loop
(:mod:`tpusplat_torch.interactive`: wasd/ec move, arrows look, q quits) on
a :class:`~tpusplat_torch.session.Session` at ``--camera`` with the tight
radius, ``--cols`` characters wide, and prints one JSON line of stats.

``--mesh DATAxTILE`` renders through the tile-sharded path, one process per
rank (``torchrun --nproc-per-node=DATA*TILE -m tpusplat_torch.viewer ...
--mesh DATAxTILE``), a batch of DATA copies of each camera. An overflow
regrows the channel that overflowed and renders again; when the retries
run out the viewer raises rather than save a truncated frame.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser("tpusplat_torch.viewer", description=__doc__)
    p.add_argument("scene", help="path to .ply scene (or 'test' for synthetic)")
    p.add_argument("-w", "--width", type=int,
                   default=int(os.environ.get("TPUSPLAT_WIDTH", 1280)))
    p.add_argument("--height", type=int,
                   default=int(os.environ.get("TPUSPLAT_HEIGHT", 720)))
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--camera", type=float, nargs=3, default=[0.0, 0.0, 5.0],
                   metavar=("X", "Y", "Z"), help="camera position")
    p.add_argument("--target", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--orbit", type=int, default=0,
                   help="render N orbit frames around the target")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--mesh", default=None,
                   help="'DATAxTILE' process mesh: render through the tile-sharded path "
                        "(Gaussians and image tile rows over TILE); one process per rank")
    p.add_argument("--dist-init", default="env://",
                   help="with --mesh: init method of the process group")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="keyboard-driven terminal loop (wasd/ec move, arrows look, q quit) "
                        "with live metrics")
    p.add_argument("--cols", type=int, default=96,
                   help="interactive terminal preview width in characters")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    if args.mesh and args.interactive:
        p.error("--mesh is not supported with --interactive (the terminal "
                "loop drives the single-device Session); drop one of them")
    from tpusplat_torch.parallel.mesh import mesh_dims_arg

    mesh_dims = mesh_dims_arg(p, args.mesh)
    if not mesh_dims:
        return _view(args, args.device, None)
    from tpusplat_torch.parallel.mesh import make_render_mesh, multihost_initialize

    dev = multihost_initialize(args.device, init_method=args.dist_init)
    try:
        return _view(args, dev, make_render_mesh(*mesh_dims))
    finally:
        torch.distributed.destroy_process_group()


def _view(args, device, mesh):

    from tpusplat_torch import RenderConfig, load_ply, random_scene, render_auto
    from tpusplat_torch.camera import look_at_camera
    from tpusplat_torch.render import compile_render
    from tpusplat_torch.io.dataset import save_png

    lead = mesh is None or mesh.rank == 0
    t0 = time.time()
    if args.scene == "test":
        params = random_scene(10_000, seed=0, sh_degree=args.sh_degree, device=device)
    else:
        params = load_ply(args.scene, device=device)
    if lead:
        print(f"loaded {params.num_gaussians} gaussians in "
              f"{(time.time() - t0) * 1e3:.0f} ms", file=sys.stderr)
    if mesh is not None:
        params = _shard(params, mesh)

    # CLI > env > defaults, as apps/viewer.py.
    cfg = dataclasses.replace(RenderConfig().with_env_overrides(), sh_degree=args.sh_degree)
    if args.interactive:
        return _interactive(args, params, cfg, device)

    frames = max(args.orbit, 1)
    render = compile_render()  # the orbit's render graphs, replayed frame to frame
    center = np.asarray(args.target)
    radius_vec = np.asarray(args.camera) - center
    for i in range(frames):
        ang = 2 * np.pi * i / frames if args.orbit else 0.0
        rot = np.array([
            [np.cos(ang), 0, np.sin(ang)],
            [0, 1, 0],
            [-np.sin(ang), 0, np.cos(ang)],
        ])
        cam = look_at_camera(center + rot @ radius_vec, center, args.width, args.height,
                             fov_deg=args.fov, device=device)
        t0 = time.time()
        with torch.no_grad():
            if mesh is None:
                img, aux, cfg = render_auto(params, cam, cfg, compiled=render)
                extra = dict(instances=int(aux["num_instances"]),
                             overflow=int(aux["capacity_overflow"]))
            else:
                img, extra, cfg = _render_mesh(params, cam, cfg, mesh)
                aux = None
        if params.device.type == "cuda":
            torch.cuda.synchronize(params.device)
        dt = time.time() - t0
        if not lead:
            continue
        out = args.output if frames == 1 else args.output.replace(".png", f"_{i:04d}.png")
        save_png(out, img)
        msg = dict(frame=i, ms=round(dt * 1e3, 1), out=out, **extra)
        print(json.dumps(msg), file=sys.stderr)
        if args.verbose and aux is not None:
            print(f"transmittance mean {float(aux['transmittance'].mean()):.3f}",
                  file=sys.stderr)



def _interactive(args, params, cfg, device):
    from tpusplat_torch.interactive import run_interactive
    from tpusplat_torch.session import Session, SessionConfig

    sess = Session(SessionConfig(width=args.width, height=args.height, fov=args.fov,
                                 render=dataclasses.replace(cfg, tight_radius=True)),
                   params=params, device=device)
    sess.position = np.asarray(args.camera, np.float64)
    stats = run_interactive(sess, cols=args.cols)
    print(json.dumps(dict(frames=stats["frames"], seconds=round(stats["seconds"], 2),
                          ema_ms=round(stats["ema_ms"] or 0.0, 1))), file=sys.stderr)


def _shard(params, mesh):
    """This rank's shard, the scene padded with dead Gaussians to a multiple
    of the tile count."""
    from tpusplat_torch.parallel.sharded import pad_params, shard_params

    return shard_params(pad_params(params, mesh.tile), mesh)


def _render_mesh(params, cam, cfg, mesh, tries: int = 4):
    """One frame through ``render_sharded`` on DATA copies of ``cam``:
    (rank 0's image, the counters summed over the mesh, cfg). An overflow
    regrows the channel that overflowed (``config.regrow``) and renders
    again; raises when ``tries`` renders all overflowed."""
    from tpusplat_torch.config import regrow
    from tpusplat_torch.parallel.collectives import all_reduce_
    from tpusplat_torch.parallel.sharded import render_sharded

    for _ in range(tries):
        imgs, counters = render_sharded(params, [cam] * mesh.data, cfg, mesh)
        total = all_reduce_(torch.stack(list(counters.values())), mesh.world_group)
        counters = {k: int(v) for k, v in zip(counters, total)}
        cfg2, changes = regrow(cfg, counters, params.num_gaussians)
        if changes is None:
            return imgs[0], counters, cfg
        cfg = cfg2
        if mesh.rank == 0:
            print(json.dumps(dict(regrow=True, **changes)), file=sys.stderr)
    raise RuntimeError(f"viewer --mesh: the frame still overflows after {tries} renders "
                       f"({counters}); not saving a truncated frame")


if __name__ == "__main__":
    main()
