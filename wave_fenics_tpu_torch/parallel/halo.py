"""Halo exchange between the blocks of a :class:`partition.BlockMesh`.

Port of ``wave_fenics_tpu.parallel.halo`` (the reference's CUDA-aware-MPI
``VectorUpdater``, demo/gpu_scatter_mpi/VectorUpdater.hpp:21-230). The
interface planes are duplicated on both neighbouring blocks, so:

- :func:`halo_add` (update_rev + update_fwd in one exchange): each side
  adds the neighbour's partial plane, after which both copies hold the
  full sum, bitwise the same (the two sums add the same two numbers);
- :func:`halo_sync` (update_fwd alone): the lower-indexed block owns each
  shared plane and its copy overwrites the neighbour's;
- :func:`refresh_value_halos`: the value-halo layouts' forward scatter of
  h-deep slabs of interior values into the neighbours' halos, with the
  shared plane canonicalised to the lower block's value.

Every sweep runs x, then y, then z, on whole planes, so edge and corner
values travel through two or three exchanges.

The exchange itself is one small interface, :class:`Exchange`: each block
hands a slab to each neighbour along an axis and receives one from each;
the imported-mesh assembly of ``sharded_general`` adds an all-gather of one
buffer a block and rounds of pairwise swaps.
:class:`LocalExchange` holds every block in this process and copies the
slabs between block tensors (across cards a ``non_blocking`` copy, which
PyTorch orders behind the work queued on both cards' current streams);
the value-halo refresh copies each slab straight into the neighbour's
halo (:meth:`Exchange.swap_into`). ``distributed.ProcessGroupExchange``
implements the same interface across processes on ``torch.distributed``.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from ..convert import to_numpy
from .partition import BlockMesh, Blocks

__all__ = [
    "Exchange",
    "LocalExchange",
    "copy_to",
    "halo_add_axis",
    "halo_add",
    "halo_sync_axis",
    "halo_sync",
    "refresh_value_halos",
]


class Exchange(Protocol):
    """Slab exchange between the blocks of ``mesh``."""

    mesh: BlockMesh

    @property
    def local_blocks(self) -> list[int]:
        """The blocks this process holds (the others are None in a Blocks)."""

    def swap(self, axis: int, to_left: Blocks, to_right: Blocks) -> tuple[Blocks, Blocks]:
        """Send each held block's ``to_left`` slab to its lower neighbour
        along ``axis`` and its ``to_right`` slab to its upper one; return
        (from_left, from_right): what each held block received from its
        lower and upper neighbour (None at the end of the axis). The slabs
        of one direction have one shape on every block; what is received
        is a copy, owned by the receiver."""

    def swap_into(self, axis: int, to_left: Blocks, to_right: Blocks,
                  into_left: Blocks, into_right: Blocks) -> None:
        """:meth:`swap`, each received slab written into the receiver's
        view: what comes from the lower neighbour into ``into_left[b]``,
        from the upper one into ``into_right[b]``. Every slab is read before
        its own block's view of the same direction is written; the views of
        one direction must not overlap the slabs of the other."""

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the processes."""

    def gather(self, blocks: Blocks) -> list[np.ndarray]:
        """Every block of a field, on the host, in every process."""

    def all_gather(self, bufs: Blocks) -> Blocks:
        """Each held block's 1D buffer, all of one length L, to every block:
        for each held block, the buffers of all blocks concatenated in block
        order ([nblocks * L], on the block's device). The held blocks of one
        device may share one result; it is only read."""

    def swap_pairs(self, pairs, sends: dict) -> dict:
        """One round of pairwise swaps: ``pairs`` are (i, j) pairs of
        blocks, no block in two; ``sends[(a, b)]`` is what held block a
        sends to its partner b (both sides of a pair send buffers of one
        length). Returns ``got[(a, b)]``: what held block a received from b,
        on a's device, to be read only (on one device it may be the
        sender's buffer itself)."""


def copy_to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``x`` on ``device`` (``non_blocking``: across cards PyTorch
    orders the copy behind both cards' current streams)."""
    return x.to(device, non_blocking=True, copy=True)


class LocalExchange:
    """Every block of ``mesh`` in this process: a slab reaches its
    neighbour as a copy on the neighbour's device."""

    def __init__(self, mesh: BlockMesh):
        self.mesh = mesh

    @property
    def local_blocks(self) -> list[int]:
        return list(range(self.mesh.nblocks))

    def swap(self, axis, to_left, to_right):
        n = self.mesh.nblocks
        from_left, from_right = Blocks([None] * n), Blocks([None] * n)
        for b in range(n):
            lo = self.mesh.neighbour(b, axis, -1)
            hi = self.mesh.neighbour(b, axis, +1)
            if lo is not None:
                from_left[b] = copy_to(to_right[lo], self.mesh.devices[b])
            if hi is not None:
                from_right[b] = copy_to(to_left[hi], self.mesh.devices[b])
        return from_left, from_right

    def swap_into(self, axis, to_left, to_right, into_left, into_right):
        """One copy a slab, from the sender's view into the receiver's, with
        no staging buffer. The upward slabs go from the top of each chain of
        blocks down and the downward ones from the bottom up, so a block's
        slab is read before its own view of that direction is written (a
        block thinner than its halo sends rows its lower neighbour's slab
        overwrites)."""
        n = self.mesh.nblocks
        for b in reversed(range(n)):
            lo = self.mesh.neighbour(b, axis, -1)
            if lo is not None:
                into_left[b].copy_(to_right[lo], non_blocking=True)
        for b in range(n):
            hi = self.mesh.neighbour(b, axis, +1)
            if hi is not None:
                into_right[b].copy_(to_left[hi], non_blocking=True)

    def allreduce(self, x):
        return x

    def gather(self, blocks):
        return [to_numpy(x) for x in blocks]

    def all_gather(self, bufs):
        """One concatenation for each device that holds blocks, shared by
        its blocks."""
        full = {}
        for dev in self.mesh.devices:
            if dev not in full:
                full[dev] = torch.cat([x if x.device == dev else copy_to(x, dev)
                                       for x in bufs])
        return Blocks(full[dev] for dev in self.mesh.devices)

    def swap_pairs(self, pairs, sends):
        got = {}
        for i, j in pairs:
            for a, b in ((i, j), (j, i)):
                x, dev = sends[(b, a)], self.mesh.devices[a]
                got[(a, b)] = x if x.device == dev else copy_to(x, dev)
        return got


def _plane(x: torch.Tensor, axis: int, i: int) -> torch.Tensor:
    return x.select(axis, i % x.shape[axis])


def halo_add_axis(blocks: Blocks, exchange: Exchange, axis: int,
                  lo: int = 0, hi: int = -1) -> Blocks:
    """Halo-add along one axis, in place: each held block's planes ``lo``
    and ``hi`` along ``axis`` (its two interface planes) gain the
    neighbour's copy of the plane, so both copies hold the two-sided sum.
    The ends of the axis keep their one-sided value. Returns ``blocks``."""
    if exchange.mesh.parts[axis] == 1:
        return blocks
    own = exchange.local_blocks
    n = len(blocks)
    to_left = Blocks(_plane(blocks[b], axis, lo) if b in own else None for b in range(n))
    to_right = Blocks(_plane(blocks[b], axis, hi) if b in own else None for b in range(n))
    from_left, from_right = exchange.swap(axis, to_left, to_right)
    for b in own:
        if from_left[b] is not None:
            _plane(blocks[b], axis, lo).add_(from_left[b])
        if from_right[b] is not None:
            _plane(blocks[b], axis, hi).add_(from_right[b])
    return blocks


def halo_add(blocks: Blocks, exchange: Exchange, planes=None, axes=(0, 1, 2)) -> Blocks:
    """Full halo-add sweep over ``axes`` (x, then y, then z), in place.
    ``planes[axis]`` = (lo, hi), the interface planes' indices (default
    the first and the last plane: the unpadded block)."""
    for axis in axes:
        lo, hi = (0, -1) if planes is None else planes[axis]
        halo_add_axis(blocks, exchange, axis, lo, hi)
    return blocks


def halo_sync_axis(blocks: Blocks, exchange: Exchange, axis: int,
                   lo: int = 0, hi: int = -1) -> Blocks:
    """Owner -> duplicate along one axis, in place (update_fwd,
    VectorUpdater.hpp:106-152): a block's plane ``hi`` overwrites its upper
    neighbour's plane ``lo``. Only needed where something broke the
    duplicated-plane invariant; the solvers keep it through halo_add."""
    if exchange.mesh.parts[axis] == 1:
        return blocks
    own = exchange.local_blocks
    n = len(blocks)
    to_left = Blocks(_plane(blocks[b], axis, lo) if b in own else None for b in range(n))
    to_right = Blocks(_plane(blocks[b], axis, hi) if b in own else None for b in range(n))
    from_left, _ = exchange.swap(axis, to_left, to_right)
    for b in own:
        if from_left[b] is not None:
            _plane(blocks[b], axis, lo).copy_(from_left[b])
    return blocks


def halo_sync(blocks: Blocks, exchange: Exchange, planes=None, axes=(0, 1, 2)) -> Blocks:
    """Full owner -> duplicate sweep (x, then y, then z), in place."""
    for axis in axes:
        lo, hi = (0, -1) if planes is None else planes[axis]
        halo_sync_axis(blocks, exchange, axis, lo, hi)
    return blocks


def refresh_value_halos(blocks: Blocks, exchange: Exchange, offsets, extents,
                        h: int) -> Blocks:
    """Overwrite the h-deep halo of each held padded block with its
    neighbours' values, in place (owner -> ghost forward scatter,
    VectorUpdater.hpp:106-152). Along axis a the interior starts at
    ``offsets[a]`` and has ``extents[a]`` points: a block sends its h planes
    after the shared one to its lower neighbour (which writes them after
    its interior) and its shared plane with the h before it to its upper
    one (which writes the h into its halo before the interior, and the
    shared plane over its own copy). The duplicated plane is so
    canonicalised to the lower block's value: the two copies could
    otherwise drift apart at the ulp level. x, then y, then z, so corner
    halos fill through the earlier axes."""
    own = exchange.local_blocks
    n = len(blocks)
    for axis in range(3):
        if exchange.mesh.parts[axis] == 1:
            continue
        o, m = offsets[axis], extents[axis]
        to_left = Blocks(blocks[b].narrow(axis, o + 1, h) if b in own else None
                         for b in range(n))
        to_right = Blocks(blocks[b].narrow(axis, o + m - 1 - h, h + 1) if b in own
                          else None for b in range(n))
        into_right = Blocks(blocks[b].narrow(axis, o + m, h) if b in own else None
                            for b in range(n))
        into_left = Blocks(blocks[b].narrow(axis, o - h, h + 1) if b in own else None
                           for b in range(n))
        exchange.swap_into(axis, to_left, to_right, into_left, into_right)
    return blocks
