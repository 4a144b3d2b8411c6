"""One-dimensional tables of the references, from first principles (NumPy,
float64): Gauss-Lobatto-Legendre nodes and weights, Gauss-Legendre points
and weights, Lagrange values and derivatives, and their assembled 1D
operators on a uniform line of cells."""

from __future__ import annotations

import numpy as np
from numpy.polynomial import legendre

__all__ = ["gll", "gauss", "lagrange", "assemble", "lumped_line", "dof_coords"]


def gll(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The n-point Gauss-Lobatto-Legendre rule on [0, 1]: the end points and
    the roots of P'_{n-1}, weights 2 / (n (n - 1) P_{n-1}(x)^2) halved."""
    c = np.zeros(n)
    c[-1] = 1.0
    dc = legendre.legder(c)
    x = legendre.legroots(dc)
    for _ in range(3):  # Newton steps to full precision
        x = x - legendre.legval(x, dc) / legendre.legval(x, legendre.legder(dc))
    x = np.concatenate([[-1.0], np.sort(x), [1.0]])
    w = 2.0 / (n * (n - 1) * legendre.legval(x, c) ** 2)
    return (x + 1.0) / 2.0, w / 2.0


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The n-point Gauss-Legendre rule on [0, 1]."""
    x, w = legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def lagrange(nodes: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(B, D): B[q, i] = l_i(x_q) and D[q, i] = l_i'(x_q) of the Lagrange
    basis on ``nodes``, by the product rule."""
    n = len(nodes)
    B = np.ones((len(x), n))
    D = np.zeros((len(x), n))
    for i in range(n):
        others = [j for j in range(n) if j != i]
        den = np.prod(nodes[i] - nodes[others])
        diff = x[:, None] - nodes[None, others]
        B[:, i] = np.prod(diff, axis=1) / den
        for k in range(n - 1):
            D[:, i] += np.prod(np.delete(diff, k, axis=1), axis=1) / den
    return B, D


def assemble(block: np.ndarray, ncells: int) -> np.ndarray:
    """The assembled (ncells p + 1)^2 matrix of one (p + 1)^2 cell block
    repeated on a line of cells, neighbours sharing their end node."""
    p = block.shape[0] - 1
    out = np.zeros((ncells * p + 1, ncells * p + 1))
    for c in range(ncells):
        out[c * p:c * p + p + 1, c * p:c * p + p + 1] += block
    return out


def lumped_line(ncells: int, p: int, h: float) -> np.ndarray:
    """The assembled diagonal of the GLL-collocated 1D mass: h w per cell."""
    _, w = gll(p + 1)
    return np.diag(assemble(np.diag(h * w), ncells)).copy()


def dof_coords(ncells: int, p: int, h: float) -> np.ndarray:
    """Coordinates of the GLL dofs on a line of ``ncells`` cells of size h."""
    x, _ = gll(p + 1)
    pts = np.zeros(ncells * p + 1)
    for c in range(ncells):
        pts[c * p:c * p + p + 1] = h * (c + x)
    return pts
