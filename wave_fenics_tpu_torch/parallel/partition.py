"""Domain decomposition of the structured box over a list of devices.

Port of ``wave_fenics_tpu.parallel.partition`` (the reference's MPI-rank
Cartesian partitioner, demo/gpu_cg/mesh.hpp:37-112, and its owned+ghost
IndexMap). The global dof grid is cut into an (mx, my, mz) grid of blocks;
each block is the local dof grid of one part *including the shared
interface planes* (duplicated with the neighbour and kept consistent by
the halo exchanges of ``parallel.halo``). Where the JAX package stores the
blocks as one blocked array ``[mx, my, mz, ...]`` sharded over a device
mesh, the port holds one tensor per block (:class:`Blocks`, C order), each
on the device :class:`BlockMesh` names for it.

:func:`decompose3d`, :func:`block_grid` and :func:`unblock_grid` are the
JAX package's, unchanged (NumPy).
"""

from __future__ import annotations

import numbers
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "decompose3d",
    "make_device_mesh",
    "BlockMesh",
    "Blocks",
    "per_block",
    "block_grid",
    "unblock_grid",
]


def decompose3d(n: int) -> tuple[int, int, int]:
    """Factor n parts into a near-cubic (mx, my, mz) process grid.

    Generalizes the reference's power-of-two split 2^x -> 2^x0 2^x1 2^x2
    (demo/gpu_cg/mesh.hpp:37-48) to arbitrary n via greedy prime assignment.
    """
    dims = [1, 1, 1]
    for f in _prime_factors(n)[::-1]:
        dims[int(np.argmin(dims))] *= f
    dims.sort(reverse=True)
    return tuple(dims)


def _prime_factors(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out)


@dataclass(frozen=True)
class BlockMesh:
    """An (mx, my, mz) grid of blocks and the device of each, in C order
    (block b = (bx * my + by) * mz + bz)."""

    parts: tuple[int, int, int]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.devices) != self.nblocks:
            raise ValueError(f"{len(self.devices)} devices for {self.nblocks} blocks")

    @property
    def nblocks(self) -> int:
        mx, my, mz = self.parts
        return mx * my * mz

    def index(self, bx: int, by: int, bz: int) -> int:
        _, my, mz = self.parts
        return (bx * my + by) * mz + bz

    def coords(self, b: int) -> tuple[int, int, int]:
        _, my, mz = self.parts
        return b // (my * mz), (b // mz) % my, b % mz

    def neighbour(self, b: int, axis: int, step: int) -> int | None:
        """The block ``step`` (+1 or -1) along ``axis`` from block b, or None
        at the end of the axis."""
        c = list(self.coords(b))
        c[axis] += step
        if not 0 <= c[axis] < self.parts[axis]:
            return None
        return self.index(*c)


def make_device_mesh(
    parts: tuple[int, int, int], devices=None, device=None
) -> BlockMesh:
    """A :class:`BlockMesh` of ``parts``: the blocks round-robin over
    ``devices`` where given; all on ``device`` where given (e.g. "cpu");
    otherwise round-robin over the visible CUDA cards (all on cuda:0 with
    one card). Raises a ValueError when no card is visible and neither is
    given: there is no fallback to the CPU."""
    parts = tuple(int(m) for m in parts)
    n = int(np.prod(parts))
    if devices is not None and device is not None:
        raise ValueError("give devices or device, not both")
    if device is not None:
        devs = [torch.device(device)] * n
    else:
        if devices is None:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if count == 0:
                raise ValueError("no CUDA card is visible: pass device='cpu' to put "
                                 "the blocks on the CPU")
            devices = [torch.device("cuda", i) for i in range(count)]
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("an empty list of devices")
        devs = [devices[b % len(devices)] for b in range(n)]
    return BlockMesh(parts, tuple(devs))


class Blocks(list):
    """The per-block tensors of one blocked field, in C block order (None
    for a block another process holds), with the block-wise arithmetic the
    solvers run on: ``x + y``, ``x - y``, ``x * y`` and ``x / y`` of two
    Blocks of one mesh, or of a Blocks and a number or a 0-d tensor ``a``
    (moved to each block's device) on either side (``a / x`` aside), and
    ``-x``. The list's own ``+`` (concatenation) and ``*`` (repetition)
    are replaced by these."""

    def _zip(self, other, fn):
        if not isinstance(other, Blocks) or len(other) != len(self):
            raise TypeError("block-wise arithmetic needs two Blocks of one mesh")
        return Blocks(None if a is None else fn(a, b) for a, b in zip(self, other))

    def _scaled(self, s, fn):
        if isinstance(s, torch.Tensor):
            if s.dim() != 0:
                raise TypeError("a Blocks field scales by a number or a 0-d tensor")
            return Blocks(None if a is None else fn(a, s.to(a.device)) for a in self)
        if isinstance(s, numbers.Number):
            return Blocks(None if a is None else fn(a, s) for a in self)
        return NotImplemented

    def _either(self, other, fn):
        if isinstance(other, Blocks):
            return self._zip(other, fn)
        return self._scaled(other, fn)

    def __add__(self, other):
        return self._either(other, lambda a, b: a + b)

    def __radd__(self, s):
        return self._scaled(s, lambda a, c: c + a)

    def __sub__(self, other):
        return self._either(other, lambda a, b: a - b)

    def __rsub__(self, s):
        return self._scaled(s, lambda a, c: c - a)

    def __mul__(self, other):
        return self._either(other, lambda a, b: a * b)

    def __rmul__(self, s):
        return self._scaled(s, lambda a, c: c * a)

    def __truediv__(self, other):
        return self._either(other, lambda a, b: a / b)

    def __neg__(self):
        return Blocks(None if a is None else -a for a in self)

    def __iadd__(self, other):
        return self + other

    def __imul__(self, s):
        return self * s


def per_block(mesh: BlockMesh, held, fn) -> Blocks:
    """Blocks of ``fn(b, coords, device)`` on the ``held`` blocks of
    ``mesh`` (None on the others)."""
    held = set(held)
    return Blocks(fn(b, mesh.coords(b), mesh.devices[b]) if b in held else None
                  for b in range(mesh.nblocks))


def block_grid(grid: np.ndarray, parts: tuple[int, int, int], p: int) -> np.ndarray:
    """Global dof grid [Nx, Ny, Nz] -> blocked [mx, my, mz, gxl, gyl, gzl].

    Block b along an axis with nl local cells covers dofs
    [b*nl*p, b*nl*p + nl*p] inclusive — consecutive blocks duplicate exactly
    one interface plane.
    """
    mx, my, mz = parts
    Nx, Ny, Nz = grid.shape
    nxl = (Nx - 1) // (mx * p) * p  # dofs-per-block minus shared plane
    nyl = (Ny - 1) // (my * p) * p
    nzl = (Nz - 1) // (mz * p) * p
    gxl, gyl, gzl = nxl + 1, nyl + 1, nzl + 1
    blocked = np.empty((mx, my, mz, gxl, gyl, gzl), dtype=grid.dtype)
    for bx in range(mx):
        for by in range(my):
            for bz in range(mz):
                blocked[bx, by, bz] = grid[
                    bx * nxl : bx * nxl + gxl,
                    by * nyl : by * nyl + gyl,
                    bz * nzl : bz * nzl + gzl,
                ]
    return blocked


def unblock_grid(blocked: np.ndarray, p: int) -> np.ndarray:
    """Inverse of :func:`block_grid` (a shared plane keeps the higher
    block's copy, which the exchanges keep equal to the lower one's)."""
    mx, my, mz, gxl, gyl, gzl = blocked.shape
    nxl, nyl, nzl = gxl - 1, gyl - 1, gzl - 1
    Nx, Ny, Nz = mx * nxl + 1, my * nyl + 1, mz * nzl + 1
    grid = np.empty((Nx, Ny, Nz), dtype=blocked.dtype)
    for bx in range(mx):
        for by in range(my):
            for bz in range(mz):
                sx = slice(bx * nxl, bx * nxl + gxl)
                sy = slice(by * nyl, by * nyl + gyl)
                sz = slice(bz * nzl, bz * nzl + gzl)
                grid[sx, sy, sz] = blocked[bx, by, bz]
    return grid
