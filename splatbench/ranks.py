"""A cell on several cards: one rank a card, over one ``torch.distributed``
group.

The process started (``python3 -m splatbench.run``) is rank 0, on
``cuda:0``. It starts ``chips - 1`` ranks (``torch.multiprocessing``,
spawn), rank r on ``cuda:r``, and every rank joins one NCCL group
through a ``FileStore`` under ``build/splatbench/``, at a fresh path each
run (no fixed ``/tmp`` path, no port). Every rank then makes the same calls of the cell's
``Mix``, in the same order, as a one-card run does: ``setup``,
``window``; after the window the ranks send rank 0 their memory peak, the
modules of JAX they hold and their trace's summary, and leave the group.
Rank 0 alone frees, checks and prints.

A failure ends the run, never hangs it: the group has a timeout; rank 0
watches the others and, as soon as one exits nonzero, kills the rest and
exits nonzero itself; each of the others exits as soon as rank 0 is gone.

For the harness's own tests the same ranks run on the CPU (``device="cpu"``,
gloo) or share one card (``device="cuda:0"``, gloo: NCCL cannot put two
ranks on one card). The one-card path never comes here.
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
import warnings
from pathlib import Path

import torch
import torch.distributed as dist

from splatbench import drive

ROOT = Path(__file__).resolve().parent.parent
STORE_DIR = ROOT / "build" / "splatbench"
RUN_TIMEOUT_S = 180  # the group's timeout in a run: no collective waits longer
JOIN_S = 60  # how long rank 0 waits for the others to exit once it is done
_MESHES: dict = {}  # this process's render meshes, made once


def mesh(data: int, tile: int):
    """The port's render mesh over this process's group, made once a
    process (its groups are collective to make and hold NCCL
    communicators)."""
    from tpusplat_torch.parallel.mesh import make_render_mesh

    key = (data, tile)
    if key not in _MESHES:
        _MESHES[key] = make_render_mesh(data, tile)
    return _MESHES[key]


def barrier(dev):
    """Every rank here, with its device's work done."""
    drive.sync(dev)
    dist.barrier()
    drive.sync(dev)


def share(value, src: int = 0):
    """Rank ``src``'s ``value`` on every rank (a picklable object)."""
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def every(value) -> list:
    """Every rank's ``value`` on every rank, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def gather(value) -> list | None:
    """Every rank's ``value`` on rank 0, in rank order; None elsewhere."""
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(value, out, dst=0)
    return out


def leave():
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(body, world: int, device: str, args=(), *, timeout_s: float = RUN_TIMEOUT_S,
           hook=None):
    """``body(rank, world, dev, *args)`` on ``world`` ranks: rank 0 in this
    process, the others started here. Returns rank 0's result. ``hook``,
    ``(fn, *hook_args)``, is called as ``fn(rank, *hook_args)`` first in
    every rank (the harness's tests plant faults with it). Raises, or exits
    the process nonzero, when any rank fails."""
    STORE_DIR.mkdir(parents=True, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="ranks-", dir=STORE_DIR)
    spec = (world, device, store_dir, timeout_s, body, tuple(args), hook)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, spec), name=f"splatbench-rank{r}")
             for r in range(1, world)]
    watch = _Watch(procs, store_dir)
    try:
        for p in procs:
            p.start()
        watch.start()
        result = _rank(0, spec)
        _join(procs)
    except BaseException:
        # A group whose rank failed may hang in its teardown: end at once.
        traceback.print_exc()
        watch.stop()
        _end(procs, store_dir)
        os._exit(1)
    watch.stop()
    _end(procs, store_dir)
    return result


def _end(procs, store_dir):
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    shutil.rmtree(store_dir, ignore_errors=True)


def _rank(rank: int, spec):
    world, device, store_dir, timeout_s, body, args, hook = spec
    # One intra-op thread a rank, as torchrun gives each of its processes
    # (OMP_NUM_THREADS=1): the ranks share one host's cores, and a pool of
    # the host's size in each would take them from the threads that
    # dispatch the ranks' steps.
    torch.set_num_threads(1)
    # The port's collectives call the old names of torch.distributed's:
    # one warning a rank and call site, which would bury the check's lines.
    warnings.filterwarnings("ignore", category=FutureWarning, module="torch.distributed")
    if hook is not None:
        hook[0](rank, *hook[1:])
    # "cuda": a card a rank, over NCCL; "cuda:0": one card for all, or "cpu": gloo.
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if device == "cuda" else "gloo"
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=dev if backend == "nccl" else None)
    result = body(rank, world, dev, *args)
    leave()
    return result


def _child(rank: int, spec):
    os.dup2(2, 1)  # rank 0 alone writes the result line
    parent = os.getppid()

    def orphaned():  # rank 0 gone: nothing will wait for this rank
        while True:
            if os.getppid() != parent:
                os._exit(3)
            time.sleep(0.5)

    threading.Thread(target=orphaned, daemon=True).start()
    try:
        _rank(rank, spec)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stderr.flush()
    os._exit(0)  # no interpreter teardown: the group is already left


class _Watch(threading.Thread):
    """Rank 0's watch over the others: the first that exits nonzero ends
    the run at once."""

    def __init__(self, procs, store_dir):
        super().__init__(daemon=True)
        self.procs, self.store_dir, self.done = procs, store_dir, threading.Event()

    def run(self):
        while not self.done.wait(0.2):
            for p in self.procs:
                if p.exitcode not in (None, 0):
                    print(f"splatbench: {p.name} exited with {p.exitcode}; ending the run",
                          file=sys.stderr, flush=True)
                    _end(self.procs, self.store_dir)
                    os._exit(1)

    def stop(self):
        self.done.set()


def _join(procs):
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p.name for p in procs if p.is_alive()]
    failed = [(p.name, p.exitcode) for p in procs if p.exitcode not in (None, 0)]
    if late or failed:
        raise RuntimeError(f"ranks did not end cleanly: still running {late}, failed {failed}")


def execute(workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
            bench_path: Path | None = None, started: float | None = None, hook=None) -> dict:
    """One run of a cell of several cards; the result line's object, from
    rank 0. ``started`` is rank 0's process start on the monotonic clock
    (``setup_s`` runs from it: starting the ranks and the group is set-up)."""
    from splatbench import run

    w = run.prepare(workload, bench_path)[1]
    started = time.monotonic() if started is None else started
    return launch(_cell, w["chips"], device, (workload, seed, seconds, traced, bench_path,
                                              started), hook=hook)


def _cell(rank, world, dev, workload, seed, seconds, traced, bench_path, started):
    from splatbench import run as runner

    bench, w, conf, traffic, limits = runner.prepare(workload, bench_path)
    run = drive.Run(conf=conf, traffic=traffic, seed=seed, seconds=seconds, traced=traced,
                    device=dev, chips=world)
    mix = drive.load_kind(traffic["kind"])(run)
    mix.setup()
    setup_s = time.monotonic() - started
    mix.window()
    mine = dict(bad=runner.forbidden_modules(),
                peak=int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0,
                trace=run.trace.summary() if run.trace is not None else None)
    every = gather(mine)
    leave()
    if rank:
        return None
    bad = sorted({m for e in every for m in e["bad"]})
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {bad}")
    dev_line = runner.device_line(dev, world)
    dev_line.update(count=world, memory_peak_bytes=max(e["peak"] for e in every))
    run.ranks = [e["trace"] for e in every]
    run.notes.update(memory_peak_bytes_by_rank=[e["peak"] for e in every])
    return runner.finish(bench, workload, run, mix, limits, setup_s, dev_line)
