"""Sharded step times: the monolithic step against the overlap-ready ones
(counterpart of ``tpusplat/bench/scaling.py``).

Times ``sharded_train_step`` (gradients summed by one all-reduce a tensor
after the backward) against ``sharded_train_step_overlap`` with the
all-reduce and with the ring, at the JAX bench's tiny scene (512 Gaussians,
96x64, SH1, a camera per data rank), on the ranks it is given: by default
two processes on one card over gloo (mesh 2x1), ``--nccl`` four processes
with a card each over NCCL (mesh 2x2), ``--device cpu`` a rehearsal on the
CPU. Step times are host clock around steps that end in a synchronisation,
after a warm-up step. It also reports the gradient all-reduce's volume at
garden scale (``allreduce_bytes``) and, under an ASSUMED 25 GB/s between two
hosts (the JAX bench's figure, not a measurement), its time.

    python -m tpusplat_torch.bench.scaling [--nccl | --device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpusplat_torch.bench._timing import emit, require_card, sync
from tpusplat_torch.parallel.dryrun import mesh_dims

SCENE = dict(n=512, w=96, h=64)
ASSUMED_HOST_GBPS = 25.0  # the JAX bench's per-host link (200 Gb/s), an assumption
GARDEN_PARAMS = 1_400_000 * 59  # trainable floats a Gaussian: 3 + 3 + 4 + 1 + 48


def _rank(rank, dev, out_path, iters):
    from tpusplat_torch import RenderConfig, look_at_camera, random_scene
    from tpusplat_torch.parallel.mesh import make_render_mesh
    from tpusplat_torch.parallel.sharded import (
        shard_state, sharded_train_step, sharded_train_step_overlap,
    )
    from tpusplat_torch.train.step import create_train_state, make_optimizer

    world = torch.distributed.get_world_size()
    data, tile = mesh_dims(world)
    mesh = make_render_mesh(data, tile)
    n, w, h = SCENE["n"], SCENE["w"], SCENE["h"]
    params = random_scene(n, seed=5, sh_degree=1, scale_range=(0.05, 0.3), device=dev)
    cfg = RenderConfig(sh_degree=1, max_per_tile=256, tile_chunk=4, gauss_chunk=16,
                       capacity_mult=16)
    cams = [look_at_camera([np.sin(i), 0.4, 7.0], [0, 0, 0], w, h, fov_deg=60.0, device=dev)
            for i in range(data)]
    targets = torch.tensor(np.random.default_rng(0).uniform(0, 1, (data, h, w, 3)),
                           dtype=torch.float32, device=dev)
    opt = make_optimizer()

    def time_step(fn, **kw):
        state = shard_state(create_train_state(params), mesh)
        state, m = fn(state, cams, targets, cfg, opt, mesh, **kw)  # warm-up
        float(m["loss"])
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = fn(state, cams, targets, cfg, opt, mesh, **kw)
        loss = float(m["loss"])
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3 / iters
        if not math.isfinite(loss) or int(state.step) != iters + 1:
            raise AssertionError(f"scaling: loss {loss}, step {int(state.step)}")
        return ms

    rows = {
        "monolithic_psum": time_step(sharded_train_step),
        "overlap_psum": time_step(sharded_train_step_overlap, grad_reduce="psum"),
        "overlap_ring": time_step(sharded_train_step_overlap, grad_reduce="ring"),
    }
    everyone = [None] * world
    torch.distributed.all_gather_object(everyone, rows)
    if rank == 0:
        Path(out_path).write_text(json.dumps(dict(
            mesh=f"{data}x{tile}", step_ms={k: max(r[k] for r in everyone) for k in rows},
            step_ms_by_rank=everyone)))


def comm_accounting(num_params: int = GARDEN_PARAMS, hosts: int = 2,
                    gbps: float = ASSUMED_HOST_GBPS) -> dict:
    """The gradient all-reduce over ``hosts`` at ``num_params`` floats, and
    its time at ``gbps`` (an assumed rate): the ring's per-host volume, and
    the one chunk that an overlapped ring leaves exposed."""
    from tpusplat_torch.parallel.collectives import allreduce_bytes

    acct = allreduce_bytes(num_params, hosts)
    comm_ms = acct["ring_bytes_per_device"] / (gbps * 1e9) * 1e3
    return dict(grad_mb=acct["grad_bytes"] / 1e6,
                ring_mb_per_host=acct["ring_bytes_per_device"] / 1e6, chunks=acct["steps"],
                assumed_gbps_per_host=gbps, comm_ms_at_assumed_rate=comm_ms,
                exposed_ms_if_overlapped=comm_ms / max(acct["steps"], 1))


def run(n_ranks: int = 2, device="cuda:0", backend: str | None = "gloo",
        iters: int = 4) -> dict:
    """The three steps on ``n_ranks`` processes (``device`` and ``backend``
    as :func:`tpusplat_torch.parallel.launch.spawn` takes them)."""
    from tpusplat_torch.parallel.launch import spawn

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "scaling.json"
        spawn(_rank, n_ranks, (str(out), iters), init_file=f"{tmp}/init", device=device,
              backend=backend)
        res = json.loads(out.read_text())
    return dict(clock="host", ranks=n_ranks, placement=str(device), backend=backend,
                scene=dict(SCENE, batch=mesh_dims(n_ranks)[0]), **res,
                garden_comm=comm_accounting())


def main(argv=None) -> int:
    p = argparse.ArgumentParser("tpusplat_torch.bench.scaling", description=__doc__)
    p.add_argument("--nccl", action="store_true",
                   help="four processes, a card each, over NCCL (needs four cards)")
    p.add_argument("--device", default="cuda:0",
                   help="'cuda:0' (default: two ranks on one card over gloo) or 'cpu' "
                        "(a rehearsal)")
    args = p.parse_args(argv)
    if args.device == "cpu":
        res = run(2, "cpu", "gloo")
        print(json.dumps(dict(device={"kind": "cpu"}, rehearsal=True, **res)), flush=True)
        return 0
    if not require_card("scaling"):
        return 1
    if args.nccl:
        if torch.cuda.device_count() < 4:
            print(f"scaling --nccl: needs 4 cards, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 1
        res = run(4, "cuda", None)
    else:
        res = run(2, args.device, "gloo")
    for k, v in res["step_ms"].items():
        print(f"{k:16s} {v:8.2f} ms/step", file=sys.stderr)
    emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
