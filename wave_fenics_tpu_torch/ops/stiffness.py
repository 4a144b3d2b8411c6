"""Banded stencil tables of the separable stiffness (host-side NumPy).

The table functions of ``wave_fenics_tpu.ops.pallas_stiffness``, copied so
that the port builds bit-identical tables without importing JAX. The fused
grid stiffness kernel of that module (``_kernel``/``_kernel_mxu``) is not
ported yet (ROADMAP.md, Queue 2).

On a uniform box the assembled 1D operator of a cell block A[m, m] is a
variable-coefficient stencil: (S u)[l] = sum_{k=-p..p} C[l mod p, k] u[l+k]
with

    r in 1..p-1:  C[r, j - r] = A[r, j]            (single covering cell)
    r == 0:       C[0, j]    += A[0, j]            (right cell)
                  C[0, j - p] += A[p, j]           (left cell)
"""

from __future__ import annotations

import numpy as np

__all__ = ["banded_1d_coeffs", "build_stencil_coeffs"]


def build_stencil_coeffs(A: np.ndarray, p: int) -> np.ndarray:
    """C[p, 2p+1] variable-coefficient stencil from the cell block A[m, m]."""
    C = np.zeros((p, 2 * p + 1), dtype=A.dtype)
    for j in range(p + 1):
        C[0, j + p] += A[0, j]       # right covering cell, k = j
        C[0, j] += A[p, j]           # left covering cell,  k = j - p
    for r in range(1, p):
        for j in range(p + 1):
            C[r, j - r + p] += A[r, j]
    return C


def _cvec(C: np.ndarray, k: int, n: int, p: int) -> np.ndarray:
    """Coefficient vector c[l] = C[l mod p, k] of length n."""
    pat = C[:, k]
    reps = -(-n // p)
    return np.tile(pat, reps)[:n]


def banded_1d_coeffs(Ad: np.ndarray, n: int, p: int, scale=1.0) -> np.ndarray:
    """Banded coefficient vectors [2p+1, n] of the assembled 1D operator
    ``scale * assemble(Ad)`` on an n-point axis, with the phantom-cell
    self-term corrections at the two domain faces (the periodic tiling of
    ``_cvec`` assumes a covering cell on both sides of every node; the
    first/last node have only one)."""
    Ad = np.asarray(Ad)
    K = 2 * p + 1
    C = build_stencil_coeffs(np.asarray(scale) * Ad, p)
    body = np.stack([_cvec(C, k, n, p) for k in range(K)])
    body[p, 0] -= scale * Ad[p, p]
    body[p, n - 1] -= scale * Ad[0, 0]
    return body
