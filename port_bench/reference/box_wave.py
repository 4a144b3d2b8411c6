"""Plain reference of the planar3d box wave (plain torch, float64).

The linear acoustic wave of demo/cpu_planar3d (waveFEniCS, main.cpp:24-66
and forms.ufl:21-24) on a box of cubic cells, GLL elements of degree p
with collocated p + 1 point quadrature:

    du/dt = v
    dv/dt = (-c0^2 K u + c0^2 g(t) W1 - c0 W2 v) / m
    g(t)  = window(t) p0 w0 / c0 cos(w0 t),  window = 0.5 (1 - cos(pi f0 t / alpha))
            for t < alpha / f0, else 1

with W1 the lumped facet mass of the source face x = 0 and W2 that of the
absorbing face x = L. On a box the stiffness and the lumped mass are
Kronecker products of assembled 1D matrices, K = S_x (x) L_y (x) L_z +
L_x (x) S_y (x) L_z + L_x (x) L_y (x) S_z and m = l_x (x) l_y (x) l_z, so
K u / m is the sum over the axes of diag(1/l_d) S_d applied along axis d,
and W1 / m, W2 / m are 1 / l_x at the two x faces. Each axis is one dense
matrix product. dt is the CFL step snapped to whole steps a period
(main.cpp:61-66), tf = L / c0 + tail periods (main.cpp:64); leapfrog takes
dt x 0.71 and ceil(n / 0.71) steps.

Schemes: classic RK4, and kick-drift-kick leapfrog with the absorbing
term semi-implicit: v+ = (v + dt/2 F(t, u)) / (1 + dt/2 D), u' = u + dt v+,
v' = (1 - dt/2 D) v+ + dt/2 F(t + dt, u'), F the v-independent
acceleration and D = c0 W2 / m.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import gll

__all__ = ["Reference", "compare", "case_steps", "cell_sizes"]


def cell_sizes(config: dict) -> tuple[float, float, float]:
    """The cell's edges: the box is L x width x width with width = L ny / nx."""
    nx, ny, nz = config["cells"]
    width = config["length"] * ny / nx
    return config["length"] / nx, width / ny, width / nz


def case_steps(config: dict, integrator: str) -> tuple[float, int]:
    """(dt, steps) of one solve from t0 = 0 to tf."""
    p = config["degree"]
    L = config["length"]
    hmin = math.sqrt(sum(x * x for x in cell_sizes(config)))  # the cell diameter
    c0, f0 = config["c0"], config["f0"]
    dt = config["cfl"] * hmin / (c0 * p ** 2)
    per_period = int((1.0 / f0) / dt) + 1
    dt = (1.0 / f0) / per_period
    steps = int((L / c0 + config["tail_periods"] / f0) / dt) + 1
    if integrator == "leapfrog":
        dt *= 0.71
        steps = math.ceil(steps / 0.71)
    return dt, steps


class Reference:
    """The box wave of ``config`` on ``device`` in float64; ``answer`` runs
    one solve of the traffic's scheme from an input state."""

    def __init__(self, config: dict, traffic: dict, device):
        self.cfg = config
        self.integrator = traffic["integrator"]
        self.dev = torch.device(device)
        nx, ny, nz = config["cells"]
        p = config["degree"]
        h = cell_sizes(config)
        nodes, w = gll.gll(p + 1)
        _, D = gll.lagrange(nodes, nodes)
        self.A = []
        lines = []
        for d, n in enumerate((nx, ny, nz)):
            S = gll.assemble(D.T @ np.diag(w) @ D / h[d], n)
            line = gll.lumped_line(n, p, h[d])
            lines.append(line)
            self.A.append(torch.tensor(S / line[:, None], dtype=torch.float64,
                                       device=self.dev))
        self.Az_t = self.A[2].T.contiguous()
        self.inv_lx0 = 1.0 / lines[0][0]
        self.inv_lxn = 1.0 / lines[0][-1]
        self.dt, self.steps = case_steps(config, self.integrator)

    def g(self, t: float) -> float:
        c = self.cfg
        f0, alpha = c["f0"], c["alpha"]
        w0 = 2.0 * math.pi * f0
        ramp = 0.5 * (1.0 - math.cos(f0 * math.pi * t / alpha)) if t < alpha / f0 else 1.0
        return ramp * c["p0"] * w0 / c["c0"] * math.cos(w0 * t)

    def _ku(self, u: torch.Tensor) -> torch.Tensor:
        """-c0^2 K u / m."""
        nx, ny, nz = u.shape
        y = (self.A[0] @ u.reshape(nx, -1)).reshape(nx, ny, nz)
        y += torch.matmul(self.A[1], u)
        y += u @ self.Az_t
        return y.mul_(-self.cfg["c0"] ** 2)

    def force(self, t: float, u: torch.Tensor) -> torch.Tensor:
        a = self._ku(u)
        a[0] += self.cfg["c0"] ** 2 * self.g(t) * self.inv_lx0
        return a

    def f1(self, t: float, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        a = self.force(t, u)
        a[-1] -= self.cfg["c0"] * self.inv_lxn * v[-1]
        return a

    def answer(self, inputs: dict) -> dict:
        u = inputs["u"].to(self.dev, torch.float64)
        v = inputs["v"].to(self.dev, torch.float64)
        dt, t = self.dt, 0.0
        if self.integrator == "rk4":
            h2 = 0.5 * dt
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
        elif self.integrator == "leapfrog":
            h2 = 0.5 * dt
            damp = self.cfg["c0"] * self.inv_lxn * h2
            F = self.force(t, u)
            for _ in range(self.steps):
                vh = v + h2 * F
                vh[-1] /= 1.0 + damp
                u = u + dt * vh
                t = t + dt
                F = self.force(t, u)
                v = vh + h2 * F
                v[-1] -= damp * vh[-1]
        else:
            raise ValueError(f"integrator {self.integrator!r}: rk4 or leapfrog")
        return {"u": u, "v": v}


def compare(answer: dict, expected: dict) -> dict:
    """The largest gap of each final field from the reference's, over the
    reference field's largest magnitude."""
    return {f"{k}_err": float((answer[k].to(expected[k].device, torch.float64)
                               - expected[k]).abs().max() / expected[k].abs().max())
            for k in ("u", "v")}
