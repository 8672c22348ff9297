"""The process mesh (counterpart of ``tpusplat/parallel/mesh.py``).

One process per mesh position, on ``torch.distributed``. Axes, as in the
JAX package:
  * ``data``: the camera batch (data parallelism); parameter gradients are
    summed over it;
  * ``tile``: Gaussians are sharded over it for preprocess, their screen
    attributes gathered over it, and the image's tile rows split over it
    for binning and blending.

Rank r sits at ``(d, t) = divmod(r, tile)``, as the JAX package lays its
devices out (``mesh.py:23-30``): the ``tile`` group of a rank holds the
ranks of its data row, the ``data`` group those of its tile column.

Backends: NCCL with one process per card, gloo on the CPU (and, staging
through host memory, for processes that share one card, where NCCL cannot
run two ranks).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """This process's place in a ("data", "tile") mesh and its groups."""

    data: int
    tile: int
    rank: int  # position in the mesh: d * tile + t
    tile_group: object  # the ranks of this data row
    data_group: object  # the ranks of this tile column
    world_group: object  # every rank of the mesh

    @property
    def d(self) -> int:
        return self.rank // self.tile

    @property
    def t(self) -> int:
        return self.rank % self.tile

    @property
    def shape(self) -> dict:
        return {"data": self.data, "tile": self.tile}


def make_render_mesh(data: int = 1, tile: int | None = None) -> RenderMesh:
    """The mesh over every process of the initialised default group. Every
    process must call it, with the same arguments, in the same order as any
    other group creation."""
    world = dist.get_world_size()
    if tile is None:
        tile = world // data
    if data < 1 or tile < 1 or data * tile != world:
        raise ValueError(f"make_render_mesh: a {data}x{tile} mesh needs {data * tile} "
                         f"processes, the group has {world}")
    rank = dist.get_rank()
    tile_group = data_group = None
    # new_group is collective: every process creates every group.
    for d in range(data):
        g = dist.new_group(list(range(d * tile, (d + 1) * tile)))
        if rank // tile == d:
            tile_group = g
    for t in range(tile):
        g = dist.new_group(list(range(t, world, tile)))
        if rank % tile == t:
            data_group = g
    return RenderMesh(data=data, tile=tile, rank=rank, tile_group=tile_group,
                      data_group=data_group, world_group=dist.group.WORLD)


def multihost_initialize(device="cuda", backend: str | None = None,
                         init_method: str = "env://", rank: int | None = None,
                         world_size: int | None = None) -> torch.device:
    """Start this process's ``torch.distributed`` default group and return
    its device (the counterpart of ``jax.distributed.initialize``).

    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE`` from
    the environment (``torchrun`` sets them). On the card the process takes
    ``cuda:LOCAL_RANK`` (0 when unset) and NCCL, on the CPU gloo; a
    ``backend`` given overrides that (gloo for processes sharing one card)."""
    dev = torch.device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost_initialize: CUDA is not available; pass "
                               "device='cpu' for gloo on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def mesh_dims_arg(parser, value: str | None):
    """(DATA, TILE) from a CLI's ``--mesh`` value, or None; ``parser.error``
    on a malformed value, or when the process has no rank in its
    environment (the CLIs run one process per rank, launched by torchrun)."""
    if not value:
        return None
    try:
        dims = tuple(int(x) for x in value.lower().split("x"))
    except ValueError:
        dims = ()
    if len(dims) != 2 or min(dims) < 1:
        parser.error("--mesh expects DATAxTILE, e.g. 1x2")
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        parser.error(f"--mesh runs one process per rank: launch it with torchrun "
                     f"--nproc-per-node={dims[0] * dims[1]} (RANK and WORLD_SIZE are not set)")
    return dims
