"""Run a function in several local processes, one rank each, as a mesh's
processes on one machine (tests, ``chip_smoke.py``). ``torchrun`` does the
same for the CLIs (``--mesh``), which read their rank from the environment.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from tpusplat_torch.parallel.mesh import multihost_initialize


def _child(rank, fn, world_size, init_file, device, backend, threads, args):
    os.environ["LOCAL_RANK"] = str(rank)  # as torchrun sets it on one machine
    torch.set_num_threads(threads)
    dev = multihost_initialize(device, backend, f"file://{init_file}", rank, world_size)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args=(), *, init_file: str, device="cuda",
          backend: str | None = None, threads: int = 1) -> None:
    """Call ``fn(rank, device, *args)`` in ``world_size`` fresh processes
    (``spawn`` start method), each a rank of a default group that starts
    from ``init_file`` (a path that must not exist yet), on ``device``:
    "cuda" (the default) gives rank r the card cuda:r and NCCL, a card with
    an index ("cuda:0") holds every rank (pass ``backend="gloo"``: NCCL
    cannot run two ranks on one card), "cpu" runs gloo on the CPU
    (:func:`~tpusplat_torch.parallel.mesh.multihost_initialize` picks the
    backend). ``fn`` must be importable by the children. Raises if a child
    fails."""
    if os.path.exists(init_file):
        raise FileExistsError(f"spawn: {init_file} exists; a group needs a fresh file")
    torch.multiprocessing.start_processes(
        _child, args=(fn, world_size, init_file, device, backend, threads, args),
        nprocs=world_size, start_method="spawn")
