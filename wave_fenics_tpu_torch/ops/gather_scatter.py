"""Gather/scatter between dof vectors and element tensors.

Port of ``wave_fenics_tpu.ops.gather_scatter``:

- the structured overlap path (``gather_1d``, ``scatter_1d``,
  ``gather_grid``, ``scatter_grid``): on a structured GLL dof grid
  (N = n*p + 1 per axis) element tensors overlap the grid in a regular
  stride-p pattern, so gather is m strided slices and scatter-add is a 1D
  overlap-add per axis; no indexed scatter, deterministic;
- the explicit-dofmap path: ``gather_indexed`` (x[dofmap]),
  ``scatter_indexed`` (an indexed add, the oracles' scatter), and kernel
  K's coloured scatter: :func:`colour_cells` splits the cells into colours
  so that no two cells of one colour share a dof, and
  :func:`scatter_coloured` adds the element tensors into a zero vector one
  colour after another, as kernel K does (``ops.general``), so the
  scatter-add needs no atomics and its result does not depend on the run;
  :func:`scatter_ordered` adds any indexed values in their flat order
  (``np.add.at``'s order), the set-up's deterministic scatter.
  The JAX package's multiplicity buckets (``build_ell_scatter``) are a TPU
  layout of the scatter and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gather_1d", "scatter_1d", "gather_grid", "scatter_grid",
           "gather_indexed", "scatter_indexed", "scatter_ordered", "colour_cells",
           "scatter_coloured"]


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


def scatter_ordered(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """y = 0, y[ids[i]] += vals[i] in the order of i (``np.add.at``'s):
    each sum is ((0 + v_first) + v_next) + ..., the same bit for bit on
    every run and device. A stable sort groups the values by id; the r-th
    value of every group is added in pass r, an ``index_add_`` whose ids
    are distinct, so no two adds meet in one place."""
    ids, vals = ids.reshape(-1).long(), vals.reshape(-1)
    s, order = torch.sort(ids, stable=True)
    k = s.numel()
    pos = torch.arange(k, device=ids.device)
    start = torch.ones(k, dtype=torch.bool, device=ids.device)
    start[1:] = s[1:] != s[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    v = vals[order]
    y = vals.new_zeros(n)
    for r in range(int(rank.max()) + 1 if k else 0):
        sel = rank == r
        y.index_add_(0, s[sel], v[sel])
    return y


def colour_cells(dofmap: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray]:
    """(cells int32 [nc], colour_starts int32 [ncolours + 1]): colour c's
    cells are ``cells[colour_starts[c]:colour_starts[c + 1]]``, in
    increasing order, and no two cells of one colour share a dof.

    Greedy, in cell order: a cell takes the lowest colour that no earlier
    cell sharing one of its 8 corner dofs holds (on a conforming hex mesh
    two cells that share a dof share a corner); on a box's cells in C order
    that is the parity colouring, (cx % 2, cy % 2, cz % 2), 8 colours.
    Every colour is then checked against all of its cells' dofs (host,
    once; the same result on every build)."""
    dm = np.asarray(dofmap)
    nc = dm.shape[0]
    corners = dm.reshape(nc, m, m, m)[:, :: m - 1, :: m - 1, :: m - 1].reshape(nc, 8)
    _, vid = np.unique(corners, return_inverse=True)
    used = [0] * (int(vid.max()) + 1)
    colour = []
    for vs in vid.reshape(nc, 8).tolist():
        busy = 0
        for v in vs:
            busy |= used[v]
        bit = ~busy & (busy + 1)  # the lowest colour free at every corner
        for v in vs:
            used[v] |= bit
        colour.append(bit.bit_length() - 1)
    colour = np.asarray(colour, dtype=np.int64)
    counts = np.bincount(colour)
    ndofs = int(dm.max()) + 1
    for c in range(counts.size):
        if np.bincount(dm[colour == c].ravel(), minlength=ndofs).max() > 1:
            raise ValueError(f"cells of colour {c} share a dof but no corner: the "
                             "mesh is not a conforming hex mesh")
    starts = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return (np.argsort(colour, kind="stable").astype(np.int32),
            starts.astype(np.int32))


def scatter_coloured(ye: torch.Tensor, dofmap: torch.Tensor, cells: torch.Tensor,
                     colour_starts: torch.Tensor, ndofs: int) -> torch.Tensor:
    """y = 0, then y[dofmap[c]] += ye[c] for the cells of each colour in
    turn (:func:`colour_cells`): each dof's sum is ((0 + s_0) + s_1) + ... in
    colour order, as kernel K's colour launches add (plain torch; no index
    repeats within a colour)."""
    y = ye.new_zeros(ndofs)
    bounds = colour_starts.tolist()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        c = cells[lo:hi].long()
        idx = dofmap[c].reshape(-1).long()
        y[idx] += ye[c].reshape(-1)
    return y
