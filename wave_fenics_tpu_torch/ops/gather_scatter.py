"""Structured 1D gather/scatter between grid axes and cell-node axes.

Port of the structured overlap path of ``wave_fenics_tpu.ops.gather_scatter``
(``gather_1d``, ``scatter_1d``): on a structured GLL dof grid (N = n*p + 1
per axis) element tensors overlap the grid in a regular stride-p pattern,
so gather is m strided slices and scatter-add is a 1D overlap-add. No
indexed scatter, no atomics, deterministic.
"""

from __future__ import annotations

import torch

__all__ = ["gather_1d", "scatter_1d"]


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
