"""Geometric factors: Jacobians, |det J| w and G = J^-1 J^-T |det J| w
(host-side NumPy, float64, once per mesh).

A copy of ``wave_fenics_tpu.core.geometry``. Its NumPy route (the JAX
package's own fallback where its native library is absent) re-derives the
reference's host precompute layer as batched einsums over [ncells, nq]:

- ``precompute_geometric_data``      (common/precomputation.hpp:18-110)
- ``compute_jacobian``               (common/precompute.hpp:49-96)
- ``compute_jacobian_determinant``   (common/precompute.hpp:102-116)
- ``compute_jacobian_inverse``       (common/precompute.hpp:122-143)
- ``compute_geometrical_factor``     (common/precompute.hpp:148-176)

Conventions:
  J[c, q, i, j] = d x_i / d xi_j  (physical coordinate i, reference j)
  detJw[c, q]   = |det J| w_q
  G[c, q, :, :] = J^-1 J^-T |det J| w_q (symmetric 3x3 per point)

On an axis-aligned uniform box J = diag(hx, hy, hz) in every cell and at
every point, so |det J| w and G collapse to closed form and G is diagonal
(``structured_geometric_factors``).

``precompute_geometric_data(..., device=...)`` takes the tensor route
instead, the counterpart of the JAX package's native route: the cells go to
the device and ``native.geometry_factors`` computes G and |det J| w there
(the hand-written kernel on a card, its plain version on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .basis import Tab1D, clamp_table, tabulate_1d
from .mesh import HexMesh, StructuredBoxMesh

__all__ = [
    "quadrature_points_3d",
    "quadrature_weights_3d",
    "trilinear_tabulate",
    "compute_jacobian",
    "compute_jacobian_determinant",
    "compute_jacobian_inverse",
    "compute_geometrical_factor",
    "precompute_geometric_data",
    "structured_geometric_factors",
]


def quadrature_points_3d(tab: Tab1D) -> np.ndarray:
    """Tensor-product quadrature points [nq^3, 3], flat order z fastest:
    q = (qi n + qj) n + qk, the C order of the element tensors."""
    X, Y, Z = np.meshgrid(tab.qpts, tab.qpts, tab.qpts, indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)


def quadrature_weights_3d(tab: Tab1D) -> np.ndarray:
    """Tensor-product weights, flat order z fastest."""
    WX, WY, WZ = np.meshgrid(tab.qwts, tab.qwts, tab.qwts, indexing="ij")
    return (WX * WY * WZ).ravel()


def trilinear_tabulate(points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The trilinear coordinate basis at ``points``: (phi[nq, 8],
    dphi[3, nq, 8]) in basix vertex order, clamped at +-1/0 (the
    coordinate-map table of precomputation.hpp:54-59)."""
    pts = np.asarray(points, dtype=np.float64)
    nq = pts.shape[0]
    phi = np.ones((nq, 8))
    dphi = np.zeros((3, nq, 8))
    for v in range(8):
        vbits = [(v >> d) & 1 for d in range(3)]
        factors = [pts[:, d] if vbits[d] else 1.0 - pts[:, d] for d in range(3)]
        phi[:, v] = factors[0] * factors[1] * factors[2]
        for d in range(3):
            dfac = np.ones(nq) if vbits[d] else -np.ones(nq)
            others = [factors[e] for e in range(3) if e != d]
            dphi[d, :, v] = dfac * others[0] * others[1]
    return clamp_table(phi), clamp_table(dphi)


def compute_jacobian(cell_coords: np.ndarray, dphi: np.ndarray) -> np.ndarray:
    """J[c, q, i, j] = sum_n coords[c, n, i] dphi[j, q, n]."""
    return np.einsum("cni,jqn->cqij", cell_coords, dphi, optimize=True)


def compute_jacobian_determinant(J: np.ndarray) -> np.ndarray:
    """det J per cell and point (signed; callers take abs, as
    precomputation.hpp:95 does)."""
    return np.linalg.det(J)


def compute_jacobian_inverse(J: np.ndarray) -> np.ndarray:
    """K = J^-1 per cell and point."""
    return np.linalg.inv(J)


def compute_geometrical_factor(
    J: np.ndarray, detJ: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    """G = J^-1 J^-T |det J| w per cell and point."""
    K = compute_jacobian_inverse(J)
    scale = np.abs(detJ) * weights[None, :]
    return np.einsum("cqij,cqkj,cq->cqik", K, K, scale, optimize=True)


def precompute_geometric_data(
    mesh: HexMesh, p: int, q: int | None = None, rule: str = "gll",
    clamp: bool = True, device: torch.device | str | None = None,
):
    """(G[nc, nq, 3, 3], detJw[nc, nq]) of a general hex mesh, float64,
    with the +-1/0 clamping of G (precomputation.hpp:105-107) unless
    ``clamp`` is False. ``device=None``: NumPy arrays (the oracle); a
    device: tensors there, from ``native.geometry_factors``."""
    tab = tabulate_1d(p, q, rule)
    w3 = quadrature_weights_3d(tab)
    _, dphi = trilinear_tabulate(quadrature_points_3d(tab))
    if device is not None:
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                                   device=device)

        return native.geometry_factors(dev(mesh.cell_coords()), dev(dphi), dev(w3),
                                       clamp)
    J = compute_jacobian(mesh.cell_coords(), dphi)
    detJ = compute_jacobian_determinant(J)
    detJw = np.abs(detJ) * w3[None, :]
    G = compute_geometrical_factor(J, detJ, w3)
    if clamp:
        G = clamp_table(G)
    return G, detJw


def structured_geometric_factors(
    mesh: StructuredBoxMesh, p: int, q: int | None = None, rule: str = "gll"
) -> tuple[np.ndarray, np.ndarray]:
    """(Gdiag[nq, 3], detJw[nq]) for an axis-aligned uniform box:
    detJw[q] = hx hy hz w_q and Gdiag[q, d] = detJw[q] / h_d^2."""
    tab = tabulate_1d(p, q, rule)
    w3 = quadrature_weights_3d(tab)
    hx, hy, hz = mesh.h
    vol = hx * hy * hz
    detJw = vol * w3
    Gdiag = detJw[:, None] / np.array([hx * hx, hy * hy, hz * hz])[None, :]
    return Gdiag, detJw
