"""The wave model on the unpadded dof grid, distributed over blocks.

Port of ``wave_fenics_tpu.parallel.sharded_wave`` (LinearGLL over a
partitioned mesh with the VectorUpdater halo exchange, SURVEY.md §3.1/§3.5):

- each block holds one part's cells and their dof grid, the interface
  planes duplicated (``parallel.partition``);
- per RK4 stage, the local stiffness (kernel F on a card, the separable
  plain version on the CPU) on every block, then one halo-add sweep
  (``parallel.halo``), then the boundary terms and 1/m point by point;
- global reductions (CG's dots) weight each copy of a dof by
  1/multiplicity (:func:`ownership_weights`), the IndexMap's owned/ghost
  distinction reduced to a static weight field.

The time loop is ``solvers.rk4`` and CG ``solvers.cg`` on the block-wise
arithmetic of :class:`partition.Blocks`; PyTorch runs eagerly, so there is
no counterpart of ``shard_map``: one process loops over the blocks it
holds.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from ..convert import tables_from_numpy, widen
from ..core.basis import lumped_weight_line
from ..core.mesh import StructuredBoxMesh
from ..models.linear_wave import (
    LinearWave,
    lumped_boundary_weights,
    require_homogeneous,
)
from ..ops.operators import StructuredOperators
from ..solvers.cg import cg
from ..solvers.rk4 import rk4_solve_n
from .halo import Exchange, LocalExchange, halo_add
from .partition import (BlockMesh, Blocks, block_grid, make_device_mesh, per_block,
                        unblock_grid)

__all__ = ["ShardedLinearWave", "ownership_weights", "block_mesh"]


def ownership_weights(
    parts: tuple[int, int, int], block_shape: tuple[int, int, int]
) -> np.ndarray:
    """Blocked weight array: 1/multiplicity for each dof copy.

    Interface planes duplicated along one axis get 1/2, edges 1/4, corners
    1/8 — so a weighted sum over all blocks counts every global dof once.
    """
    mx, my, mz = parts
    gxl, gyl, gzl = block_shape
    out = np.ones((mx, my, mz, gxl, gyl, gzl))
    for b_axis, (m, g) in enumerate(zip(parts, block_shape)):
        for b in range(m):
            w = np.ones(g)
            if b > 0:
                w[0] = 0.5
            if b < m - 1:
                w[-1] = 0.5
            shape = [1] * 6
            shape[3 + b_axis] = g
            idx = [slice(None)] * 6
            idx[b_axis] = b
            out[tuple(idx)] *= w.reshape(shape[3:])
    return out


def block_mesh(model, parts, devices=None, device=None, exchange=None) -> BlockMesh:
    """The block mesh of a sharded model: the exchange's where one is given,
    else ``make_device_mesh(parts, devices, device)``, the blocks on the
    CPU when the model is and neither is given."""
    parts = tuple(int(m) for m in parts)
    if exchange is not None:
        if exchange.mesh.parts != parts:
            raise ValueError(f"the exchange's mesh has parts {exchange.mesh.parts}, "
                             f"not {parts}")
        return exchange.mesh
    if devices is None and device is None and model.device.type == "cpu":
        device = "cpu"
    return make_device_mesh(parts, devices, device)


class ShardedLinearWave:
    """``LinearWave`` distributed over an (mx, my, mz) grid of blocks; the
    physics is the single-device model's, and the tests hold the two
    together at 1e-12. ``devices``/``device`` place the blocks
    (``partition.make_device_mesh``; by default the model's device type);
    ``exchange`` (default ``halo.LocalExchange``: every block in this
    process) moves the slabs."""

    def __init__(self, model: LinearWave, parts, devices=None, device=None,
                 exchange: Exchange | None = None):
        require_homogeneous(model, "ShardedLinearWave")
        self.model = model
        self.parts = tuple(int(m) for m in parts)
        for n, m in zip(model.mesh.shape, self.parts):
            if n % m != 0:
                raise ValueError(
                    f"cells {model.mesh.shape} not divisible by mesh {self.parts}")
        self.mesh = block_mesh(model, self.parts, devices, device, exchange)
        self.exchange = exchange if exchange is not None else LocalExchange(self.mesh)

    @cached_property
    def local_cells(self) -> tuple[int, int, int]:
        return tuple(n // m for n, m in zip(self.model.mesh.shape, self.parts))

    @cached_property
    def block_shape(self) -> tuple[int, int, int]:
        return tuple(n * self.model.p + 1 for n in self.local_cells)

    @cached_property
    def local_ops(self) -> StructuredOperators:
        """Every block's operators: a local box mesh of the same cell sizes
        (the tables depend only on (h, p), so one set serves every block)."""
        gm = self.model.mesh
        extent = tuple(h * n for h, n in zip(gm.h, self.local_cells))
        local = StructuredBoxMesh(shape=self.local_cells, extent=extent,
                                  origin=gm.origin)
        return StructuredOperators(local, self.model.p, dtype=self.model.dtype)

    # -- blocked constant fields ---------------------------------------
    def _blocked(self, blocked_np: np.ndarray) -> Blocks:
        """A blocked NumPy array [mx, my, mz, ...] as Blocks of the model's
        dtype on the held blocks' devices."""
        return per_block(self.mesh, self.exchange.local_blocks, lambda i, c, dev:
                         tables_from_numpy((blocked_np[c],), dev, self.model.dtype)[0])

    def _from_grid(self, grid_np: np.ndarray) -> Blocks:
        return self._blocked(block_grid(np.asarray(grid_np), self.parts, self.model.p))

    @cached_property
    def W1(self) -> Blocks:
        md = self.model
        facets = md.mesh.facet_tags.facets_of(md.source_tag)
        return self._from_grid(lumped_boundary_weights(md.mesh, md.p, facets))

    @cached_property
    def W2(self) -> Blocks:
        md = self.model
        facets = md.mesh.facet_tags.facets_of(md.abc_tag)
        return self._from_grid(lumped_boundary_weights(md.mesh, md.p, facets))

    @cached_property
    def inv_m(self) -> Blocks:
        gm, p = self.model.mesh, self.model.p
        lines = [lumped_weight_line(gm.shape[d], p, gm.h[d]) for d in range(3)]
        return self._from_grid(1.0 / np.einsum("i,j,k->ijk", *lines))

    @cached_property
    def own_w(self) -> Blocks:
        """The ownership weights (:func:`ownership_weights`) per block."""
        return self._blocked(ownership_weights(self.parts, self.block_shape))

    # -- state ----------------------------------------------------------
    def zero_state(self) -> tuple[Blocks, Blocks]:
        def zeros(i, c, dev):
            return torch.zeros(self.block_shape, dtype=self.model.dtype, device=dev)

        held = self.exchange.local_blocks
        return per_block(self.mesh, held, zeros), per_block(self.mesh, held, zeros)

    def to_global(self, blocked: Blocks) -> np.ndarray:
        arrs = self.exchange.gather(blocked)
        mx, my, mz = self.parts
        return unblock_grid(np.stack(arrs).reshape(mx, my, mz, *arrs[0].shape),
                            self.model.p)

    def from_global(self, grid: np.ndarray) -> Blocks:
        return self._from_grid(grid)

    # -- distributed operators ------------------------------------------
    def _f1(self, t, u: Blocks, v: Blocks) -> Blocks:
        """dv/dt: the local stiffness, the halo-add, then the boundary terms
        and 1/m (``LinearWave.f1``'s order)."""
        md = self.model
        own = self.exchange.local_blocks
        b = Blocks([None] * len(u))
        for i in own:
            b[i] = self.local_ops.stiffness(u[i], md.c0)
        halo_add(b, self.exchange)
        g = md._g(t)
        for i in own:
            b[i] = (b[i] + g * self.W1[i] - md.c0 * (self.W2[i] * v[i])) * self.inv_m[i]
        return b

    def solve(self, t0: float, tf: float, dt: float, u0=None, v0=None):
        return self.solve_n(t0, dt, int(round((tf - t0) / dt)), u0, v0)

    def solve_n(self, t0: float, dt: float, nsteps: int, u0=None, v0=None):
        """RK4, ``nsteps`` steps; returns (u, v, nsteps) as Blocks."""
        if u0 is None:
            u0, v0 = self.zero_state()
        u, v = rk4_solve_n(lambda t, u, v: v, self._f1, Blocks(u0), Blocks(v0),
                           t0, dt, nsteps)
        return u, v, nsteps

    # -- distributed linear algebra --------------------------------------
    def dot(self, a: Blocks, b: Blocks) -> torch.Tensor:
        """Ownership-weighted global inner product (the MPI_Allreduce of
        cublasDdot, cg.hpp:88-91): a 0-d tensor on the first held block's
        device, in the arithmetic type (float32 for bf16 blocks)."""
        own = self.exchange.local_blocks
        dev = self.mesh.devices[own[0]]
        s = sum(torch.dot(*widen((self.own_w[i] * a[i]).reshape(-1), b[i].reshape(-1)))
                .to(dev) for i in own)
        return self.exchange.allreduce(s)

    def _local_then_add(self, x: Blocks, fn) -> Blocks:
        y = Blocks(fn(xb) if xb is not None else None for xb in x)
        return halo_add(y, self.exchange)

    def stiffness(self, x: Blocks, c0: float) -> Blocks:
        """The distributed matrix-free stiffness matvec."""
        return self._local_then_add(x, lambda xb: self.local_ops.stiffness(xb, c0))

    def spectral_mass(self, x: Blocks) -> Blocks:
        return self._local_then_add(x, self.local_ops.spectral_mass)

    def cg_mass(self, b: Blocks, kmax: int = 50, rtol: float = 1e-8,
                precond=None):
        """CG on the spectral mass with the weighted dot: the gpu_cg
        workload distributed (cg.hpp:37-121). Returns (x, iterations,
        |r|^2)."""
        x0 = Blocks(None if x is None else torch.zeros_like(x) for x in b)
        return cg(self.spectral_mass, b, x0=x0, kmax=kmax, rtol=rtol,
                  precond=precond, dot=self.dot)
