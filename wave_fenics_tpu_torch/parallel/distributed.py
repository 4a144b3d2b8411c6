"""Multi-process runs on ``torch.distributed``.

Port of ``wave_fenics_tpu.parallel.distributed``. The reference binds one
MPI rank per GPU (demo/gpu_cg/main.cpp:31-50, common/cuda/utils.hpp:22-38);
here each process joins one process group (NCCL between cards, gloo on the
CPU) and drives the blocks it owns, on its own device.
:class:`ProcessGroupExchange` is ``halo.Exchange`` across processes: a slab
between blocks of one process is copied as ``halo.LocalExchange`` copies
it, a slab between processes goes by ``dist.batch_isend_irecv``; so do the
pairwise swaps of the imported-mesh assembly, whose all-gather is
``dist.all_gather``.

Nothing tells a process of a cluster: :func:`initialize` takes the address,
the world size and the rank from its arguments or from the environment
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..convert import to_numpy
from .halo import copy_to
from .partition import BlockMesh, Blocks, decompose3d

__all__ = [
    "initialize",
    "global_device_mesh",
    "process_summary",
    "ProcessGroupExchange",
]


def initialize(device: str | torch.device | None = None, **kwargs) -> None:
    """Join the process group (a no-op when already in one, or for a
    single process: no ``init_method`` given and no ``WORLD_SIZE`` in the
    environment). The backend is NCCL for a CUDA ``device`` (the default
    where a card is visible), gloo for the CPU; ``kwargs`` go to
    ``dist.init_process_group`` (``init_method``, ``world_size``,
    ``rank``)."""
    if dist.is_initialized():
        return
    if "init_method" not in kwargs and "WORLD_SIZE" not in os.environ:
        return
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, **kwargs)


def _local_device() -> torch.device:
    """This process's device: the card of its local rank on NCCL, else the
    CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("cpu")


def global_device_mesh(parts: tuple[int, int, int] | None = None) -> BlockMesh:
    """The block mesh of all processes: ``parts`` (default one block per
    process, factored near-cubically by ``decompose3d``), each block on its
    owner's device (``ProcessGroupExchange.owner``; a process sees only its
    own blocks, so the others carry its device too)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if parts is None:
        parts = decompose3d(world)
    n = int(np.prod(parts))
    if n < world:
        raise ValueError(f"{n} blocks for {world} processes: each process needs one")
    return BlockMesh(tuple(parts), (_local_device(),) * n)


def process_summary() -> str:
    """Rank/size/device line (the reference's startup prints)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return (f"process {rank}/{world}, backend: {backend}, device: "
            f"{_local_device()}")


class ProcessGroupExchange:
    """``halo.Exchange`` over the current process group: block b belongs to
    process ``owner(b)`` = b * world // nblocks (contiguous runs of blocks
    in C order), which holds it on ``mesh.devices[b]``."""

    def __init__(self, mesh: BlockMesh, group=None):
        if not dist.is_initialized():
            raise ValueError("ProcessGroupExchange needs a process group: call "
                             "distributed.initialize first")
        self.mesh = mesh
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        if mesh.nblocks < self.world:
            raise ValueError(f"{mesh.nblocks} blocks for {self.world} processes")

    def owner(self, b: int) -> int:
        return b * self.world // self.mesh.nblocks

    @property
    def local_blocks(self) -> list[int]:
        return [b for b in range(self.mesh.nblocks) if self.owner(b) == self.rank]

    def swap(self, axis, to_left, to_right):
        """The messages of one axis in one order on every process (block,
        then direction), tagged by receiving block and direction, so both
        gloo's tags and NCCL's in-order matching pair them."""
        n = self.mesh.nblocks
        from_left, from_right = Blocks([None] * n), Blocks([None] * n)
        ops = []
        for b in range(n):
            for step, src, dst in ((-1, to_left, from_right), (+1, to_right, from_left)):
                nb = self.mesh.neighbour(b, axis, step)
                if nb is None:
                    continue
                tag = 2 * nb + (1 if step < 0 else 0)
                mine, theirs = self.owner(b) == self.rank, self.owner(nb) == self.rank
                if mine and theirs:
                    dst[nb] = copy_to(src[b], self.mesh.devices[nb])
                elif mine:
                    ops.append(dist.P2POp(dist.isend, src[b].contiguous(),
                                          self.owner(nb), self.group, tag))
                elif theirs:
                    # the slab has the shape of the receiver's own slab of
                    # the same direction
                    buf = torch.empty_like(src[nb], memory_format=torch.contiguous_format)
                    ops.append(dist.P2POp(dist.irecv, buf, self.owner(b), self.group,
                                          tag))
                    dst[nb] = buf
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_left, from_right

    def swap_into(self, axis, to_left, to_right, into_left, into_right):
        """:meth:`swap` (every slab taken before any view is written), then
        each received slab copied into its view."""
        from_left, from_right = self.swap(axis, to_left, to_right)
        for b in self.local_blocks:
            if from_left[b] is not None:
                into_left[b].copy_(from_left[b])
            if from_right[b] is not None:
                into_right[b].copy_(from_right[b])

    def allreduce(self, x):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def all_gather(self, bufs):
        """``dist.all_gather`` of each process's held buffers, concatenated
        and padded to the most blocks a process holds; the result, in block
        order, is shared by the held blocks (one device a process)."""
        own = self.local_blocks
        n = self.mesh.nblocks
        per_rank = [sum(1 for b in range(n) if self.owner(b) == r)
                    for r in range(self.world)]
        x = bufs[own[0]]
        length = x.numel()
        mine = x.new_zeros(max(per_rank) * length)
        torch.cat([bufs[b] for b in own], out=mine[: len(own) * length])
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine, group=self.group)
        full = torch.cat([t[: k * length] for t, k in zip(parts, per_rank)])
        return Blocks(full if b in own else None for b in range(n))

    def swap_pairs(self, pairs, sends):
        """The messages in one order on every process (pair, then
        direction), tagged by receiver and sender; a buffer from another
        process has the length of the receiver's own buffer to it."""
        n = self.mesh.nblocks
        got, ops = {}, []
        for i, j in pairs:
            for a, b in ((i, j), (j, i)):  # a receives from b
                mine, theirs = self.owner(a) == self.rank, self.owner(b) == self.rank
                tag = a * n + b
                if mine and theirs:
                    got[(a, b)] = copy_to(sends[(b, a)], self.mesh.devices[a])
                elif theirs:
                    ops.append(dist.P2POp(dist.isend, sends[(b, a)].contiguous(),
                                          self.owner(a), self.group, tag))
                elif mine:
                    buf = torch.empty_like(sends[(a, b)],
                                           memory_format=torch.contiguous_format)
                    ops.append(dist.P2POp(dist.irecv, buf, self.owner(b), self.group, tag))
                    got[(a, b)] = buf
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got

    def gather(self, blocks):
        mine = {b: to_numpy(blocks[b]) for b in self.local_blocks}
        parts = [None] * self.world
        dist.all_gather_object(parts, mine, group=self.group)
        out = {}
        for d in parts:
            out.update(d)
        return [out[b] for b in range(self.mesh.nblocks)]
