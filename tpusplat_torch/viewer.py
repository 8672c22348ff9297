"""CLI renderer of the port (counterpart of ``apps/viewer.py``).

Renders one or more cameras to PNG files and prints one JSON line per frame
to stderr. Run as ``python -m tpusplat_torch.viewer test -w 1920 --height
1080 --orbit 3``. The flags are those of ``apps/viewer.py`` plus
``--device``; ``--mesh``, ``--interactive`` and ``--xla`` are not ported
yet. ``TPUSPLAT_*`` environment variables apply under the flags.
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
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    from tpusplat_torch import RenderConfig, load_ply, random_scene, render_auto
    from tpusplat_torch.camera import look_at_camera
    from tpusplat_torch.io.dataset import save_png

    t0 = time.time()
    if args.scene == "test":
        params = random_scene(10_000, seed=0, sh_degree=args.sh_degree, device=args.device)
    else:
        params = load_ply(args.scene, device=args.device)
    print(f"loaded {params.num_gaussians} gaussians in "
          f"{(time.time() - t0) * 1e3:.0f} ms", file=sys.stderr)

    # CLI > env > defaults, as apps/viewer.py.
    cfg = dataclasses.replace(RenderConfig().with_env_overrides(), sh_degree=args.sh_degree)

    frames = max(args.orbit, 1)
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
                             fov_deg=args.fov, device=args.device)
        t0 = time.time()
        with torch.no_grad():
            img, aux, cfg = render_auto(params, cam, cfg)
        if params.device.type == "cuda":
            torch.cuda.synchronize(params.device)
        dt = time.time() - t0
        out = args.output if frames == 1 else args.output.replace(".png", f"_{i:04d}.png")
        save_png(out, img)
        msg = dict(frame=i, ms=round(dt * 1e3, 1), out=out,
                   instances=int(aux["num_instances"]),
                   overflow=int(aux["capacity_overflow"]))
        print(json.dumps(msg), file=sys.stderr)
        if args.verbose:
            print(f"transmittance mean {float(aux['transmittance'].mean()):.3f}",
                  file=sys.stderr)


if __name__ == "__main__":
    main()
