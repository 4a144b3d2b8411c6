"""Plain reference of the planar3d wave on a jittered hex mesh (plain
torch, float64).

The wave of ``box_wave`` (demo/cpu_planar3d, main.cpp:24-66 and
forms.ufl:21-24; classic RK4 only) on the mesh of ``meshes.py``: trilinear
hex cells whose vertices form a lattice, GLL elements of degree p with
collocated p + 1 point quadrature. Everything is computed on the lattice
of vertices and the lattice of GLL nodes, node (p cx + a, p cy + b,
p cz + c) being cell (cx, cy, cz)'s local node (a, b, c), so nothing here
depends on how a program numbers, keys or colours its dofs:

- at each GLL point of each cell, the Jacobian J of the trilinear map
  (the derivatives of the eight vertex basis functions), then
  G = J^-1 J^-T |det J| w and the lumped mass |det J| w, w the tensor GLL
  weight; G in blocks of cells, each entry within 1e-8 + 1e-5 |v| of
  v = -1, 0 or 1 set to v, as the demo snaps its tables
  (common/precomputation.hpp:105-107: numpy.isclose's tolerances; on this
  mesh G is of the order of h w, so entries below 1e-8 become 0);
- the facet weights of the faces x = 0 (source) and x = L (absorbing):
  at each facet GLL point the surface element |dx/deta x dx/dzeta| of the
  bilinear facet times the weights;
- K u: each cell's nodes read from the lattice, the reference gradient at
  the points as one product with the stacked Kronecker factors
  (D x I x I, I x D x I, I x I x D), the 3 x 3 G at each point, the
  transposed product, and the cells' results added into the lattice
  (axis by axis, neighbours sharing their end nodes); in blocks of cells;
- dv/dt = (-c0^2 K u + c0^2 g(t) W1 - c0 W2 v) / m, RK4 as ``box_wave``;
- dt: the CFL step on the mesh's smallest cell diameter (the largest
  distance between two vertices of a cell; DOLFINx ``mesh::h``,
  main.cpp:47-58), snapped to whole steps a period (main.cpp:61-66), and
  tf = Lx / c0 + tail periods with Lx the mesh's x extent (main.cpp:64).

G is computed once per :class:`Reference` and serves every answer.
``compare`` is ``box_wave.compare``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import meshes
from . import gll
from .box_wave import compare

__all__ = ["Reference", "compare", "case_steps", "hmin", "BLOCK_CELLS"]

#: cells a block at most (whole planes of cells along x)
BLOCK_CELLS = 1 << 16
F64 = torch.float64


def hmin(X: np.ndarray) -> float:
    """The smallest cell diameter of the vertex lattice X [nx+1, ny+1, nz+1, 3]."""
    nx, ny, nz = (n - 1 for n in X.shape[:3])
    corners = [X[a:a + nx, b:b + ny, c:c + nz]
               for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    diam = np.zeros((nx, ny, nz))
    for i in range(8):
        for j in range(i + 1, 8):
            np.maximum(diam, np.linalg.norm(corners[i] - corners[j], axis=-1), out=diam)
    return float(diam.min())


def case_steps(config: dict, X: np.ndarray | None = None) -> tuple[float, int]:
    """(dt, steps) of one RK4 solve from t0 = 0 to tf on the configuration's
    mesh (its vertex lattice X, made when not given)."""
    X = meshes.vertex_lattice(config) if X is None else X
    c0, f0, p = config["c0"], config["f0"], config["degree"]
    dt = config["cfl"] * hmin(X) / (c0 * p ** 2)
    per_period = int((1.0 / f0) / dt) + 1
    dt = (1.0 / f0) / per_period
    L = float(X[..., 0].max() - X[..., 0].min())
    return dt, int((L / c0 + config["tail_periods"] / f0) / dt) + 1


def _fold(E: torch.Tensor, d: int, p: int) -> torch.Tensor:
    """Dims d, d + 1 of E, (cells n, local nodes p + 1), added into one dim
    of n p + 1 nodes, neighbouring cells sharing their end node."""
    n = E.shape[d]
    out = E.new_empty((*E.shape[:d], n * p + 1, *E.shape[d + 2:]))
    at = (slice(None),) * d
    out[at + (slice(0, n * p),)].unflatten(d, (n, p)).copy_(E.narrow(d + 1, 0, p))
    out[at + (slice(n * p, None),)].zero_()
    out[at + (slice(p, None, p),)] += E.select(d + 1, p)
    return out


def assemble(E: torch.Tensor, p: int) -> torch.Tensor:
    """Cell values E [nx, ny, nz, m, m, m] added into the node lattice."""
    y = E.permute(0, 3, 1, 4, 2, 5)
    for d in range(3):
        y = _fold(y, d, p)
    return y


def _corners(X: torch.Tensor) -> torch.Tensor:
    """[2, 2, 2, nx, ny, nz, 3]: each cell's vertex (a, b, c)."""
    nx, ny, nz = (n - 1 for n in X.shape[:3])
    return torch.stack([torch.stack([torch.stack([X[a:a + nx, b:b + ny, c:c + nz]
                                                  for c in (0, 1)]) for b in (0, 1)])
                        for a in (0, 1)])


class Reference:
    """The mesh wave of ``config`` on ``device`` in float64; ``answer`` runs
    one RK4 solve from an input state on the node lattice."""

    def __init__(self, config: dict, traffic: dict, device):
        if traffic["integrator"] != "rk4":
            raise ValueError(f"integrator {traffic['integrator']!r}: rk4 only")
        self.cfg = config
        dev = self.dev = torch.device(device)
        p = self.p = config["degree"]
        m = p + 1
        nx, ny, nz = config["cells"]
        Xn = meshes.vertex_lattice(config)
        self.dt, self.steps = case_steps(config, Xn)
        X = torch.tensor(Xn, dtype=F64, device=dev)

        nodes, w = gll.gll(m)
        _, D = gll.lagrange(nodes, nodes)
        eye = np.eye(m)
        Dk = np.concatenate([np.kron(np.kron(D, eye), eye), np.kron(np.kron(eye, D), eye),
                             np.kron(np.kron(eye, eye), D)])  # [3 m^3, m^3]
        self.Dk = torch.tensor(Dk, dtype=F64, device=dev)
        self.DkT = self.Dk.T.contiguous()
        r = torch.tensor(nodes, dtype=F64, device=dev)
        lin = torch.stack([1.0 - r, r], dim=1)  # [m, 2]: the vertex basis at the nodes
        dlin = torch.tensor([[-1.0, 1.0]], dtype=F64, device=dev).expand(m, 2)
        wt = torch.tensor(w, dtype=F64, device=dev)
        w3 = (wt[:, None, None] * wt[None, :, None] * wt[None, None, :]).reshape(-1)

        # G and the lumped mass, a block of x planes of cells at a time
        self.planes = max(1, BLOCK_CELLS // (ny * nz))
        self.G = torch.empty((nx * ny * nz, 3, 3, m ** 3), dtype=F64, device=dev)
        mass_e = torch.empty((nx * ny * nz, m ** 3), dtype=F64, device=dev)
        for x0 in range(0, nx, self.planes):
            x1 = min(nx, x0 + self.planes)
            C = _corners(X[x0:x1 + 1])
            cols = [torch.einsum("ia,jb,kc,abcxyzd->xyzijkd", *f, C)
                    for f in ((dlin, lin, lin), (lin, dlin, lin), (lin, lin, dlin))]
            J = torch.stack(cols, dim=-1).reshape(-1, m ** 3, 3, 3)  # dx_d / dxi_e
            det = torch.linalg.det(J)
            Jinv = torch.linalg.inv(J)
            s = slice(x0 * ny * nz, x1 * ny * nz)
            G = Jinv @ Jinv.transpose(-1, -2) * (det.abs() * w3)[..., None, None]
            for v in (-1.0, 0.0, 1.0):
                G = torch.where((G - v).abs() <= 1e-8 + 1e-5 * abs(v), v, G)
            self.G[s] = G.permute(0, 2, 3, 1)
            mass_e[s] = det.abs() * w3
        mass = assemble(mass_e.view(nx, ny, nz, m, m, m), p)
        self.neg_c2_inv_m = -config["c0"] ** 2 / mass

        def facet_weights(F):
            """The facet weights of the plane of vertices F [ny+1, nz+1, 3]."""
            Fc = torch.stack([torch.stack([F[b:b + ny, c:c + nz] for c in (0, 1)])
                              for b in (0, 1)])  # [2, 2, ny, nz, 3]
            xe = torch.einsum("ib,jc,bcyzd->yzijd", dlin, lin, Fc)
            xz = torch.einsum("ib,jc,bcyzd->yzijd", lin, dlin, Fc)
            Js = torch.linalg.cross(xe, xz, dim=-1).norm(dim=-1)
            Wf = Js * wt[:, None] * wt[None, :]  # [ny, nz, m, m]
            return _fold(_fold(Wf.permute(0, 2, 1, 3), 0, p), 1, p)

        c0 = config["c0"]
        self.src = c0 ** 2 * facet_weights(X[0]) / mass[0]
        self.damp = c0 * facet_weights(X[-1]) / mass[-1]

    def g(self, t: float) -> float:
        c = self.cfg
        f0, alpha = c["f0"], c["alpha"]
        w0 = 2.0 * math.pi * f0
        ramp = 0.5 * (1.0 - math.cos(f0 * math.pi * t / alpha)) if t < alpha / f0 else 1.0
        return ramp * c["p0"] * w0 / c["c0"] * math.cos(w0 * t)

    def stiffness(self, u: torch.Tensor) -> torch.Tensor:
        """K u on the node lattice."""
        p, m = self.p, self.p + 1
        nx, ny, nz = self.cfg["cells"]
        y = torch.empty_like(u) if self.planes < nx else None
        for x0 in range(0, nx, self.planes):
            x1 = min(nx, x0 + self.planes)
            E = (u[x0 * p:x1 * p + 1].unfold(0, m, p).unfold(1, m, p).unfold(2, m, p)
                 .reshape(-1, m ** 3))
            g = (E @ self.DkT).view(E.shape[0], 3, m ** 3)
            G = self.G[x0 * ny * nz:x1 * ny * nz]
            w = G[:, :, 0] * g[:, 0:1]
            w.addcmul_(G[:, :, 1], g[:, 1:2]).addcmul_(G[:, :, 2], g[:, 2:3])
            ye = assemble((w.view(E.shape[0], -1) @ self.Dk).view(x1 - x0, ny, nz, m, m, m), p)
            if y is None:
                return ye
            if x0 == 0:
                y[:x1 * p + 1] = ye
            else:
                y[x0 * p + 1:x1 * p + 1] = ye[1:]
                y[x0 * p] += ye[0]
        return y

    def f1(self, t: float, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        a = self.stiffness(u).mul_(self.neg_c2_inv_m)
        a[0] += self.g(t) * self.src
        a[-1] -= self.damp * v[-1]
        return a

    def answer(self, inputs: dict) -> dict:
        u = inputs["u"].to(self.dev, F64)
        v = inputs["v"].to(self.dev, F64)
        dt, t, h2 = self.dt, 0.0, 0.5 * self.dt
        for _ in range(self.steps):
            k1 = self.f1(t, u, v)
            s2v = v + h2 * k1
            k2 = self.f1(t + h2, u + h2 * v, s2v)
            s3v = v + h2 * k2
            k3 = self.f1(t + h2, u + h2 * s2v, s3v)
            s4v = v + dt * k3
            k4 = self.f1(t + dt, u + dt * s3v, s4v)
            u = u + dt / 6.0 * (v + 2.0 * s2v + 2.0 * s3v + s4v)
            v = v + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            t = t + dt
        return {"u": u, "v": v}
