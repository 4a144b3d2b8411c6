"""Sum-factorized element kernels: batched 1D tensor contractions (plain torch).

Port of ``wave_fenics_tpu.ops.element_kernels``: every element operator
is three batched 1D contractions per tensor direction, O(m^4) per cell
instead of the reference's full nd x nq table
(common/cuda/mass_kernel.cu:22-32, common/operators.hpp:112-133).

Element tensors: ``u[c, i, j, k]`` with i -> x, j -> y, k -> z (C order, z
fastest). Tables: ``B[q, i]`` (values), ``D[q, i]`` (derivatives) from
``core.basis``. The diagonal forms serve the structured operators; the
interpolating forms (``interp3``, ``grad3``, their transposes,
``mass_element``, ``stiffness_element_full``) serve the explicit-dofmap
operators (``ops.operators.GeneralOperators``, ``ops.general``).
"""

from __future__ import annotations

import torch

__all__ = [
    "apply_axis",
    "interp3",
    "interp3_t",
    "grad3",
    "grad3_t",
    "mass_element",
    "spectral_mass_element",
    "stiffness_element_diag",
    "stiffness_element_full",
]

_AXIS_SPECS = {1: "qi,cijk->cqjk", 2: "qj,cijk->ciqk", 3: "qk,cijk->cijq"}


def apply_axis(u: torch.Tensor, M: torch.Tensor, axis: int) -> torch.Tensor:
    """out[c, ..., q, ...] = sum_n M[q, n] u[c, ..., n, ...] along element
    axis ``axis`` (1, 2 or 3)."""
    return torch.einsum(_AXIS_SPECS[axis], M, u)


def interp3(u: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Nodal tensor -> quadrature tensor: B on every axis (the two Dgemms
    of demo/gpu_operator/main.cpp:149-155, sum-factorized)."""
    return apply_axis(apply_axis(apply_axis(u, B, 1), B, 2), B, 3)


def interp3_t(u: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Transpose of :func:`interp3`: B^T on every axis."""
    Bt = B.T
    return apply_axis(apply_axis(apply_axis(u, Bt, 1), Bt, 2), Bt, 3)


def grad3(u: torch.Tensor, B: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Reference-space gradient at the quadrature points, g[3, c, qx, qy,
    qz]: the derivative along axis d takes D on axis d and B on the others."""
    gx = apply_axis(apply_axis(apply_axis(u, D, 1), B, 2), B, 3)
    gy = apply_axis(apply_axis(apply_axis(u, B, 1), D, 2), B, 3)
    gz = apply_axis(apply_axis(apply_axis(u, B, 1), B, 2), D, 3)
    return torch.stack([gx, gy, gz])


def grad3_t(fw: torch.Tensor, B: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Transpose of :func:`grad3`: y = sum_d (grad_d)^T fw[d]."""
    Bt, Dt = B.T, D.T
    yx = apply_axis(apply_axis(apply_axis(fw[0], Dt, 1), Bt, 2), Bt, 3)
    yy = apply_axis(apply_axis(apply_axis(fw[1], Bt, 1), Dt, 2), Bt, 3)
    yz = apply_axis(apply_axis(apply_axis(fw[2], Bt, 1), Bt, 2), Dt, 3)
    return yx + yy + yz


def spectral_mass_element(u: torch.Tensor, detJw: torch.Tensor) -> torch.Tensor:
    """Collocated (diagonal) mass y_e = detJw .* x_e
    (common/cuda/transform.cu:5-20)."""
    return u * detJw


def mass_element(u: torch.Tensor, B: torch.Tensor, detJw: torch.Tensor) -> torch.Tensor:
    """y_e = B^T diag(detJw) B x_e, sum-factorized (the reference's
    mass_apply, common/cuda/mass_kernel.cu:4-46). ``detJw`` broadcasts:
    [1, q, q, q] or [nc, q, q, q]."""
    return interp3_t(interp3(u, B) * detJw, B)


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


def stiffness_element_full(
    u: torch.Tensor, B: torch.Tensor, D: torch.Tensor, G: torch.Tensor, coeff
) -> torch.Tensor:
    """Stiffness with the full 3x3 geometric factor, the reference skernel
    (common/operators.hpp:112-133): w_d = grad_d u at the quadrature points,
    fw = coeff G w, y = grad^T fw. ``G`` broadcasts: [1 or nc, q, q, q, 3,
    3]. With collocated GLL (B = I) the B contractions are exact copies."""
    w = grad3(u, B, D)  # [3, c, q, q, q]
    fw = coeff * torch.einsum("cqrsde,dcqrs->ecqrs", G, w)
    return grad3_t(fw, B, D)
