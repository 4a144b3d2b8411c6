"""Sum-factorized element kernels: batched 1D tensor contractions (plain torch).

Port of the structured part of ``wave_fenics_tpu.ops.element_kernels``:
every element operator is three batched 1D contractions per tensor
direction, O(m^4) per cell instead of the reference's full nd x nq table
(common/cuda/mass_kernel.cu:22-32, common/operators.hpp:112-133).

Element tensors: ``u[c, i, j, k]`` with i -> x, j -> y, k -> z (C order, z
fastest). Tables: ``B[q, i]`` (values), ``D[q, i]`` (derivatives) from
``core.basis``. The full-G stiffness (``stiffness_element_full``) and the
interpolating kernels (``interp3``, ``interp3_t``, ``mass_element``) serve
imported meshes and wait for the general-mesh slice.
"""

from __future__ import annotations

import torch

__all__ = [
    "apply_axis",
    "spectral_mass_element",
    "stiffness_element_diag",
]

_AXIS_SPECS = {1: "qi,cijk->cqjk", 2: "qj,cijk->ciqk", 3: "qk,cijk->cijq"}


def apply_axis(u: torch.Tensor, M: torch.Tensor, axis: int) -> torch.Tensor:
    """out[c, ..., q, ...] = sum_n M[q, n] u[c, ..., n, ...] along element
    axis ``axis`` (1, 2 or 3)."""
    return torch.einsum(_AXIS_SPECS[axis], M, u)


def spectral_mass_element(u: torch.Tensor, detJw: torch.Tensor) -> torch.Tensor:
    """Collocated (diagonal) mass y_e = detJw .* x_e
    (common/cuda/transform.cu:5-20)."""
    return u * detJw


def stiffness_element_diag(
    u: torch.Tensor, D: torch.Tensor, Gdiag: torch.Tensor, coeff
) -> torch.Tensor:
    """Collocated stiffness with a diagonal geometric factor (axis-aligned
    cells): y_e = coeff sum_d D_d^T diag(Gdiag[..., d]) D_d x_e, coeff =
    -c0^2 (the reference skernel's sign, common/operators.hpp:112-133).
    ``Gdiag`` broadcasts: [1, m, m, m, 3] or [nc, m, m, m, 3]."""
    yx = apply_axis(Gdiag[..., 0] * apply_axis(u, D, 1), D.T, 1)
    yy = apply_axis(Gdiag[..., 1] * apply_axis(u, D, 2), D.T, 2)
    yz = apply_axis(Gdiag[..., 2] * apply_axis(u, D, 3), D.T, 3)
    return coeff * (yx + yy + yz)
