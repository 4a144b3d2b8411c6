"""Separable grid-space stiffness for uniform structured meshes (plain torch).

Port of ``wave_fenics_tpu.ops.separable``. On a uniform axis-aligned box
the diagonal geometric factor makes the GLL stiffness operator separable:

    K u = sum_d  (L_{d'} (x) L_{d''})  .*  B_d(A_d) u

where, for axis d with 1D differentiation matrix D and GLL weights w,
A_d = (h_{d'} h_{d''} / h_d) * D^T diag(w) D is a constant m x m block,
B_d(A) is the cell-blockwise application of A along axis d with
overlap-add, and L_d is the overlap-added lumped GLL weight line of axis d
(dimensionless; the h scalings are folded into A_d).

This is the port's CPU oracle of the stiffness; the tables are host NumPy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import numpy_dtype
from ..core.basis import gll_points_weights, lumped_weight_line, tabulate_1d
from .gather_scatter import gather_1d, scatter_1d

__all__ = [
    "separable_stiffness_tables",
    "apply_block_axis",
    "stiffness_separable",
    "grid_lines",
]


def separable_stiffness_tables(
    p: int, h: tuple[float, float, float], dtype
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(A, L): per-axis m x m cell blocks and lumped weight lines (NumPy)."""
    tab = tabulate_1d(p)
    _, w = gll_points_weights(p + 1)
    DtWD = tab.D.T @ (w[:, None] * tab.D)
    npdt = numpy_dtype(dtype)
    A = []
    for d in range(3):
        others = [h[e] for e in range(3) if e != d]
        A.append((others[0] * others[1] / h[d] * DtWD).astype(npdt))
    # dimensionless lines (h folded into A); length set per axis by caller
    return A, [w.astype(npdt) for _ in range(3)]


# Contraction specs per gathered axis: contract the node dim (axis+1) with
# A[i, m] in place, leaving the other dims untouched.
_AXIS_EINSUM = {0: "im,nmbc->nibc", 1: "im,anmc->anic", 2: "im,abnm->abni"}


def apply_block_axis(
    x: torch.Tensor, A: torch.Tensor, p: int, axis: int
) -> torch.Tensor:
    """Cell-blockwise 1D operator along ``axis`` with overlap-add:
    out[c*p + i] += sum_j A[i, j] x[c*p + j] per cell c."""
    xe = gather_1d(x, p, axis)  # [..., n, m, ...] node dim at axis+1
    ye = torch.einsum(_AXIS_EINSUM[axis], A, xe)
    return scatter_1d(ye, p, axis)


def stiffness_separable(
    x: torch.Tensor,
    A: list[torch.Tensor],
    lines: list[torch.Tensor],
    p: int,
    coeff,
) -> torch.Tensor:
    """y = coeff * sum_d (L_d' x L_d'') .* B_d(A_d) x on the dof grid."""
    Lx, Ly, Lz = lines
    tx = apply_block_axis(x, A[0], p, 0) * (Ly[None, :, None] * Lz[None, None, :])
    ty = apply_block_axis(x, A[1], p, 1) * (Lx[:, None, None] * Lz[None, None, :])
    tz = apply_block_axis(x, A[2], p, 2) * (Lx[:, None, None] * Ly[None, :, None])
    return coeff * (tx + ty + tz)


def grid_lines(
    shape: tuple[int, int, int], p: int, dtype
) -> list[np.ndarray]:
    """Dimensionless overlap-added GLL weight lines per axis."""
    return [
        lumped_weight_line(n, p, 1.0).astype(numpy_dtype(dtype)) for n in shape
    ]
