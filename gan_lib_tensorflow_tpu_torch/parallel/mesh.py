"""Device mesh over the process group (port of ``gan_lib_tensorflow_tpu/
parallel/mesh.py:13-38``).

One process per rank, as ``torchrun`` starts them. A ``Mesh`` lays the
ranks out row-major over named axes: ``('data',)`` for data parallelism,
``('data', 'model')`` for DP x TP, where the ranks of one 'model' group
hold the shards of the same wide parameters and see the same batch rows, or
``('data', 'sp')`` for PGGAN's spatial partitioning, where the ranks of one
'sp' group see the same batch rows and each holds its rows of the height.
Each axis has one process group per line of the mesh; a rank keeps the
group of its own line.

``init_distributed`` joins the group ``torchrun`` describes. The backend
follows from the devices, with no flag: NCCL when every rank of the host
has a card of its own, gloo otherwise (ranks that share one card, or the
CPU). ``sharded_step`` marks the code that runs on a batch sharded over
'data' (and the height over 'sp'): inside it batch norm, minibatch stddev
and the step's draws take the global batch, and ``active()`` gives the
layers the 'sp' group of their halo exchanges (``parallel/sharding.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import socket
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device


@dataclasses.dataclass(eq=False)
class Mesh:
    """``shape`` ranks over ``axis_names``, seen from rank ``rank``:
    ``groups[axis]`` is the process group of the rank's line along
    ``axis``, ``device`` the rank's device, ``n_cards`` the number of
    distinct devices under the whole mesh (two ranks on one card count
    once)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, Any]
    n_cards: int

    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for an axis the mesh does not have)."""
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        if axis not in self.axis_names:
            return 0
        return _unravel(self.rank, self.shape)[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)


def _unravel(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for n in reversed(shape):
        rank, c = divmod(rank, n)
        coords.append(c)
    return tuple(reversed(coords))


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each of the host's ``local_world`` ranks has a card of its
    own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_distributed(device="cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``), unless the process has joined one
    already; returns the rank's device: ``cuda:<LOCAL_RANK mod cards>`` for
    ``cuda``, else ``device`` itself."""
    dev = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        dist.init_process_group(choose_backend(dev, local_world))
    return dev


def create_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Sequence[str] = ("data",), device="cuda") -> Mesh:
    """A mesh over every rank of the process group (joined first with
    ``init_distributed`` when the process has not joined one). The default
    shape is ``(world,)`` along the first axis and 1 along the others; pass
    ``shape=(d, m), axis_names=('data', 'model')`` for DP x TP. Every rank
    must call this with the same arguments (it makes the axis groups)."""
    dev = init_distributed(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    groups = {}
    for k, axis in enumerate(axis_names):
        others = [range(n) for i, n in enumerate(shape) if i != k]
        for rest in itertools.product(*others):  # every rank makes every group
            coords = [list(rest[:k]) + [c] + list(rest[k:]) for c in range(shape[k])]
            ranks = [_ravel(c, shape) for c in coords]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    places = [None] * world
    dist.all_gather_object(places, (socket.gethostname(), str(dev)))
    mesh = Mesh(shape=shape, axis_names=axis_names, rank=rank, device=dev,
                backend=dist.get_backend(), groups=groups,
                n_cards=len(set(places)))
    if rank == 0:
        print(f"[mesh] {dict(zip(axis_names, shape))} over {world} ranks on "
              f"{mesh.n_cards} device(s), backend {mesh.backend} "
              f"(rank 0 on {dev})", flush=True)
    return mesh


def _ravel(coords: Sequence[int], shape: Sequence[int]) -> int:
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + c
    return r


def is_writer() -> bool:
    """True on rank 0, or outside a process group: the process that logs,
    draws sample grids and writes checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing outside a process group)."""
    if dist.is_initialized():
        dist.barrier()


_ACTIVE: Optional[Mesh] = None


def active() -> Optional[Mesh]:
    """The mesh of the enclosing ``sharded_step``, or None."""
    return _ACTIVE


@contextlib.contextmanager
def sharded_step(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the body on a batch sharded over ``mesh``'s 'data' axis (no-op
    for None)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = prev
