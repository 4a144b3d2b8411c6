"""1D GLL basis and quadrature (host-side NumPy).

A copy of the 1D part of ``wave_fenics_tpu.core.basis``; the port cannot
import that package (its ``__init__`` imports JAX). Mapping to the
Basix-backed tabulation layer of the reference (wave-fenics):

- GLL quadrature rule        -> ``basix::quadrature::make_quadrature(gll, hexahedron, q)``
                                (common/precomputation.hpp:48-51)
- GLL-warped Lagrange basis  -> ``basix::create_element(P, hexahedron, p, gll_warped)``
                                (common/operators.hpp:20-23)
- quadrature-degree map q(p) -> common/operators.hpp:63-72
- 1D tabulation              -> ``tabulate_1d`` (common/precompute.hpp:179-189)
- +-1/0 clamping             -> common/operators.hpp:26-29

Everything here is host-side NumPy (setup path, runs once); the resulting
tables are tiny (<= (p+1) x (nq) doubles) and are fed to the torch operators.

Reference element is the unit cube [0,1]^3 (DOLFINx convention); 1D rules
are produced on [0,1].
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

__all__ = [
    "qdegree",
    "lumped_weight_line",
    "gll_points_weights",
    "gauss_points_weights",
    "lagrange_tabulate_1d",
    "tabulate_1d",
    "Tab1D",
    "clamp_table",
]

# Quadrature-degree map used throughout the reference
# (common/operators.hpp:63-72, common/precomputation.hpp:36-45).
# For every entry, the GLL rule of this degree has exactly p+1 points per
# dimension, i.e. quadrature points coincide with the GLL-warped Lagrange
# nodes -> collocation -> diagonal mass matrix.
QDEGREE: dict[int, int] = {
    1: 1,  # not in the reference map; 2 pts/dim keeps collocation at p=1
    2: 3,
    3: 4,
    4: 6,
    5: 8,
    6: 10,
    7: 12,
    8: 14,
    9: 16,
    10: 18,
}


def qdegree(p: int) -> int:
    """Quadrature degree for basis degree ``p`` (reference q(p) map)."""
    try:
        return QDEGREE[p]
    except KeyError:
        raise ValueError(f"degree p={p} outside supported range 1..10") from None


def gll_rule_size(q: int) -> int:
    """Number of 1D GLL points for exactness degree ``q``.

    An n-point Gauss-Lobatto-Legendre rule integrates polynomials of degree
    2n-3 exactly, so n = ceil((q + 3) / 2).
    """
    return -(-(q + 3) // 2)


@functools.lru_cache(maxsize=None)
def _gll_points_weights_m11(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point GLL rule on [-1, 1].

    Points are the roots of (1 - x^2) P'_{n-1}(x); weights
    w_i = 2 / (n (n-1) [P_{n-1}(x_i)]^2).
    """
    if n < 2:
        raise ValueError("GLL rule needs n >= 2")
    # Interior points: roots of P'_{n-1}.
    legcoef = np.zeros(n)
    legcoef[n - 1] = 1.0
    dcoef = np.polynomial.legendre.legder(legcoef)
    interior = np.polynomial.legendre.legroots(dcoef)
    # Newton-polish the roots to full double precision.
    for _ in range(3):
        val = np.polynomial.legendre.legval(interior, dcoef)
        dval = np.polynomial.legendre.legval(
            interior, np.polynomial.legendre.legder(dcoef)
        )
        interior = interior - val / dval
    pts = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    pn = np.polynomial.legendre.legval(pts, legcoef)
    wts = 2.0 / (n * (n - 1) * pn**2)
    return pts, wts


def gll_points_weights(n: int, dtype=np.float64) -> tuple[np.ndarray, np.ndarray]:
    """n-point GLL quadrature rule mapped to [0, 1]."""
    pts, wts = _gll_points_weights_m11(n)
    return ((pts + 1.0) / 2.0).astype(dtype), (wts / 2.0).astype(dtype)


def gauss_points_weights(n: int, dtype=np.float64) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule mapped to [0, 1].

    Used by the decomposed-operator benchmark path, which evaluates at Gauss
    (non-collocated) points (demo/gpu_operator/main.cpp:94-112).
    """
    pts, wts = np.polynomial.legendre.leggauss(n)
    return ((pts + 1.0) / 2.0).astype(dtype), (wts / 2.0).astype(dtype)


def lagrange_tabulate_1d(
    nodes: np.ndarray, x: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Values and first derivatives of the Lagrange basis on ``nodes`` at ``x``.

    Returns (B, D) with B[q, i] = l_i(x_q), D[q, i] = l'_i(x_q).
    Uses the direct product formulas in float64 (tables are tiny; stability
    is fine for the <= 19 GLL nodes we ever use).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = nodes.size
    B = np.ones((x.size, n), dtype=np.float64)
    D = np.zeros((x.size, n), dtype=np.float64)
    for i in range(n):
        others = np.delete(np.arange(n), i)
        denom = np.prod(nodes[i] - nodes[others])
        diffs = x[:, None] - nodes[None, others]  # [nq, n-1]
        B[:, i] = np.prod(diffs, axis=1) / denom
        # l'_i(x) = sum_k prod_{j != k} (x - x_j) / denom
        for k in range(n - 1):
            mask = np.delete(np.arange(n - 1), k)
            D[:, i] += np.prod(diffs[:, mask], axis=1)
        D[:, i] /= denom
    return B, D


def clamp_table(table: np.ndarray, tol: float = 1e-9) -> np.ndarray:
    """Snap values close to -1, 0, 1 to exact values.

    Mirrors the xt::filtration(isclose(...)) clamping the reference applies to
    every tabulated table (common/operators.hpp:26-29,
    common/precomputation.hpp:55-57): GLL tables are analytically 0/1 at
    collocated nodes and the clamp removes O(1e-16) noise so that collocated
    interpolation matrices are exactly the identity.
    """
    out = np.array(table, copy=True)
    for v in (-1.0, 0.0, 1.0):
        out[np.isclose(out, v, rtol=1e-5, atol=1e-8)] = v
    return out


@dataclass(frozen=True)
class Tab1D:
    """1D tabulation bundle: the sum-factorization building block.

    Equivalent of ``tabulate_1d`` (common/precompute.hpp:179-189), plus the
    quadrature rule itself.

    Attributes:
      nodes: basis (GLL) nodes on [0,1], shape [nd]
      qpts:  quadrature points on [0,1], shape [nq]
      qwts:  quadrature weights, shape [nq]
      B:     basis values,      B[q, i] = l_i(qpts[q]),  shape [nq, nd]
      D:     basis derivatives, D[q, i] = l'_i(qpts[q]), shape [nq, nd]
      collocated: True when qpts == nodes (B is the identity)
    """

    nodes: np.ndarray
    qpts: np.ndarray
    qwts: np.ndarray
    B: np.ndarray
    D: np.ndarray
    collocated: bool

    @property
    def nd(self) -> int:
        return self.nodes.size

    @property
    def nq(self) -> int:
        return self.qpts.size


@functools.lru_cache(maxsize=None)
def tabulate_1d(p: int, q: int | None = None, rule: str = "gll") -> Tab1D:
    """Tabulate the 1D degree-``p`` GLL Lagrange basis at a quadrature rule.

    Args:
      p: basis degree (nodes = p+1 GLL points on [0,1] — the ``gll_warped``
         Lagrange variant of the reference, common/operators.hpp:20-22).
      q: quadrature exactness degree. Defaults: GLL -> the reference q(p)
         map (p+1 points, collocation); GAUSS -> 2p, the reference's own
         choice for its Gauss-rule demo (demo/gpu_operator/main.cpp:96),
         giving p+1 points. (The GLL-oriented q(p) map under a Gauss rule
         yields only p points — a rank-deficient B and a SINGULAR mass
         matrix; round 3 bug found by a CG drive on a gauss operator.)
      rule: 'gll' (reference default) or 'gauss' (gpu_operator bench path).
    """
    if q is None:
        q = 2 * p if rule == "gauss" else qdegree(p)
    nodes, _ = gll_points_weights(p + 1)
    if rule == "gll":
        nq = gll_rule_size(q)
        qpts, qwts = gll_points_weights(nq)
    elif rule == "gauss":
        nq = -(-(q + 1) // 2)  # n-point Gauss exact to 2n-1
        qpts, qwts = gauss_points_weights(nq)
    else:
        raise ValueError(f"unknown quadrature rule {rule!r}")
    B, D = lagrange_tabulate_1d(nodes, qpts)
    B = clamp_table(B)
    D = clamp_table(D)
    collocated = qpts.size == nodes.size and np.allclose(qpts, nodes, atol=1e-14)
    if collocated:
        B = np.eye(nodes.size)
    return Tab1D(nodes=nodes, qpts=qpts, qwts=qwts, B=B, D=D, collocated=collocated)


def lumped_weight_line(ncells: int, p: int, h: float) -> np.ndarray:
    """1D lumped GLL weight line: overlap-add of per-cell quadrature weights
    scaled by the cell size h. Shape [ncells*p + 1].

    Building block for closed-form lumped mass / facet-mass vectors on
    structured meshes (the m = M @ 1 of LinearGLL.hpp:105-110, separable).
    """
    _, w = gll_points_weights(p + 1)
    out = np.zeros(ncells * p + 1)
    for c in range(ncells):
        out[c * p : (c + 1) * p + 1] += w
    return h * out
