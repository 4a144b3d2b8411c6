"""Geometric factors of an axis-aligned uniform box (host-side NumPy).

A copy of the structured part of ``wave_fenics_tpu.core.geometry``
(``quadrature_weights_3d``, ``structured_geometric_factors``). On such a
box J = diag(hx, hy, hz) in every cell and at every quadrature point, so
|det J| w and G = J^-1 J^-T |det J| w collapse to closed form and G is
diagonal. The general-mesh precompute (Jacobians per cell and point,
common/precomputation.hpp:18-110) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from .basis import Tab1D, tabulate_1d
from .mesh import StructuredBoxMesh

__all__ = ["quadrature_weights_3d", "structured_geometric_factors"]


def quadrature_weights_3d(tab: Tab1D) -> np.ndarray:
    """Tensor-product weights, flat order z fastest."""
    WX, WY, WZ = np.meshgrid(tab.qwts, tab.qwts, tab.qwts, indexing="ij")
    return (WX * WY * WZ).ravel()


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
