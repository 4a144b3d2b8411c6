"""Gather/scatter between dof vectors and element tensors.

Port of ``wave_fenics_tpu.ops.gather_scatter``:

- the structured overlap path (``gather_1d``, ``scatter_1d``,
  ``gather_grid``, ``scatter_grid``): on a structured GLL dof grid
  (N = n*p + 1 per axis) element tensors overlap the grid in a regular
  stride-p pattern, so gather is m strided slices and scatter-add is a 1D
  overlap-add per axis; no indexed scatter, deterministic;
- the explicit-dofmap path: ``gather_indexed`` (x[dofmap]),
  ``scatter_indexed`` (an indexed add, the oracles' scatter) and the
  transpose tables of ``build_ell_scatter`` in CSR form
  (:func:`build_scatter_csr`): per dof, the flat element entries that add
  into it, in increasing order. :func:`scatter_csr` sums them in that fixed
  order, as kernel K's scatter phase does (``ops.general``), so the
  scatter-add needs no atomics and its result does not depend on the run.
  The JAX package's multiplicity buckets (``EllScatter``) are a TPU layout
  of the same table and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gather_1d", "scatter_1d", "gather_grid", "scatter_grid",
           "gather_indexed", "scatter_indexed", "build_scatter_csr", "scatter_csr"]


def _along(axis: int, s: slice) -> tuple:
    return (slice(None),) * axis + (s,)


def gather_1d(arr: torch.Tensor, p: int, axis: int) -> torch.Tensor:
    """Split one grid axis of size n*p+1 into (n, p+1) overlapping cell axes.

    out[..., c, i, ...] = arr[..., c*p + i, ...]; the new cell axis replaces
    ``axis`` and the local-node axis is ``axis+1``.
    """
    N = arr.shape[axis]
    if (N - 1) % p != 0:
        raise ValueError(
            f"grid axis {axis} has size {N}, not n*p+1 for degree p={p}"
        )
    n = (N - 1) // p
    parts = [
        arr[_along(axis, slice(i, i + (n - 1) * p + 1, p))]
        for i in range(p + 1)
    ]
    return torch.stack(parts, dim=axis + 1)


def scatter_1d(ye: torch.Tensor, p: int, axis: int) -> torch.Tensor:
    """Overlap-add the (cell, node) axis pair back onto one grid axis.

    Inverse-transpose of :func:`gather_1d`:
    out[..., g, ...] = sum_{c*p+i == g} ye[..., c, i, ...].
    """
    n = ye.shape[axis]
    m = ye.shape[axis + 1]
    if m != p + 1:
        raise ValueError(f"node axis has {m} entries, expected p+1 = {p + 1}")
    N = n * p + 1
    # nodes i in [0, p) tile grid positions [0, n*p); node p of cell c lands
    # on (c+1)*p, where it adds to node 0 of cell c+1 (or the last point)
    lo = ye.narrow(axis + 1, 0, p).flatten(axis, axis + 1)
    hi = ye.select(axis + 1, p)
    shape = list(lo.shape)
    shape[axis] = N
    out = ye.new_zeros(shape)
    out[_along(axis, slice(0, n * p))] = lo
    out[_along(axis, slice(p, N, p))] += hi
    return out


def gather_grid(grid: torch.Tensor, p: int) -> torch.Tensor:
    """Grid [Nx, Ny, Nz] -> element tensors [ncells, m, m, m], cells in
    C order over (cx, cy, cz) (the dofmap gather of
    common/cuda/scatter.cu:47-55 on a structured mesh)."""
    a = gather_1d(grid, p, 0)  # [nx, m, Ny, Nz]
    a = gather_1d(a, p, 2)  # [nx, m, ny, m, Nz]
    a = gather_1d(a, p, 4)  # [nx, m, ny, m, nz, m]
    a = a.permute(0, 2, 4, 1, 3, 5)  # [nx, ny, nz, m, m, m]
    nx, ny, nz, m, _, _ = a.shape
    return a.reshape(nx * ny * nz, m, m, m)


def scatter_grid(
    ye: torch.Tensor, p: int, cells_shape: tuple[int, int, int]
) -> torch.Tensor:
    """Element tensors [ncells, m, m, m] -> grid [Nx, Ny, Nz] with
    overlap-add (the atomicAdd scatter of common/cuda/scatter.cu:57-65,
    deterministic here)."""
    nx, ny, nz = cells_shape
    m = ye.shape[-1]
    a = ye.reshape(nx, ny, nz, m, m, m).permute(0, 3, 1, 4, 2, 5)
    a = scatter_1d(a, p, 4)  # [nx, m, ny, m, Nz]
    a = scatter_1d(a, p, 2)  # [nx, m, Ny, Nz]
    return scatter_1d(a, p, 0)  # [Nx, Ny, Nz]


def gather_indexed(x: torch.Tensor, dofmap: torch.Tensor) -> torch.Tensor:
    """xe[c, n] = x[dofmap[c, n]] on a flat dof vector."""
    return x[dofmap.long()]


def scatter_indexed(ye: torch.Tensor, dofmap: torch.Tensor, ndofs: int) -> torch.Tensor:
    """y[dofmap[c, n]] += ye[c, n] (``index_add_``: on a card its atomics
    add in no fixed order)."""
    return ye.new_zeros(ndofs).index_add_(0, dofmap.reshape(-1).long(), ye.reshape(-1))


def build_scatter_csr(dofmap: np.ndarray, ndofs: int) -> tuple[np.ndarray, np.ndarray]:
    """(order int32 [nc*nd], starts int32 [ndofs + 1]): the flat element
    entries ``order[starts[d]:starts[d+1]]`` add into dof d, in increasing
    entry order (the transpose tables of the JAX package's
    ``build_ell_scatter``; host, once)."""
    flat = np.asarray(dofmap).ravel()
    if flat.size >= 2**31:
        raise ValueError(f"{flat.size} element entries do not fit int32 tables")
    order = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=ndofs)
    if counts.size != ndofs or counts.min() < 1:
        raise ValueError("every dof must appear in the dofmap, and only dofs < ndofs")
    starts = np.zeros(ndofs + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return order, starts.astype(np.int32)


def scatter_csr(ye: torch.Tensor, order: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """y[d] = sum over k in [starts[d], starts[d+1]) of ye.ravel()[order[k]],
    summed in that order: ((0 + s0) + s1) + ..., as kernel K's scatter phase
    sums (plain torch, one masked pass per multiplicity)."""
    vals = ye.reshape(-1)[order.long()]
    lo = starts[:-1].long()
    counts = starts[1:].long() - lo
    y = ye.new_zeros(counts.numel())
    for j in range(int(counts.max())):
        live = counts > j
        y[live] += vals[lo[live] + j]
    return y
