"""Plain reference of CEED BP1 with CG (plain torch, float64).

The consistent mass of degree-p GLL Lagrange elements with q Gauss points
a direction (demo/gpu_cg/bp1.ufl:20-21, q = p + 2 as BP1 defines it) on a
box of cubic cells. On a box it is the Kronecker product of three
assembled 1D masses, M = M_x (x) M_y (x) M_z, each cell block
h B^T diag(w_q) B with B the basis at the Gauss points, so a matvec is one
dense matrix product an axis.

CG as demo/gpu_cg/CUDA/cg.hpp:37-121 runs it, unpreconditioned, x0 = 0:
r0 = b - M x0, stop once |r|^2 / |r0|^2 < rtol^2 or after kmax
iterations, p <- r + beta p.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gll

__all__ = ["Reference", "compare"]


class Reference:
    """The BP1 system of ``config`` on ``device`` in float64; ``answer``
    runs CG on one right-hand side."""

    def __init__(self, config: dict, traffic: dict, device):
        self.cfg = config
        self.dev = torch.device(device)
        p = config["degree"]
        nodes, _ = gll.gll(p + 1)
        xq, wq = gll.gauss(config["gauss_points"])
        B, _ = gll.lagrange(nodes, xq)
        block = B.T @ np.diag(wq) @ B
        L = config["length"]
        cells = config["cells"]
        self.M = [torch.tensor(gll.assemble(L / n * block, n), dtype=torch.float64,
                               device=self.dev) for n in cells]
        self.Mz_t = self.M[2].T.contiguous()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        nx, ny, nz = x.shape
        y = (self.M[0] @ x.reshape(nx, -1)).reshape(nx, ny, nz)
        y = torch.matmul(self.M[1], y)
        return y @ self.Mz_t

    def answer(self, inputs: dict) -> dict:
        b = inputs["b"].to(self.dev, torch.float64)
        kmax, rtol = self.cfg["kmax"], self.cfg["rtol"]
        x = torch.zeros_like(b)
        r = b - self.matvec(x)
        p = r
        rnorm0 = torch.dot(r.ravel(), r.ravel())
        rnorm = rnorm0
        k = 0
        while k < kmax and float(rnorm / rnorm0) >= rtol ** 2:
            y = self.matvec(p)
            alpha = rnorm / torch.dot(p.ravel(), y.ravel())
            x = x + alpha * p
            r = r - alpha * y
            rnew = torch.dot(r.ravel(), r.ravel())
            p = r + (rnew / rnorm) * p
            rnorm = rnew
            k += 1
        return {"x": x, "iters": k}


def compare(answer: dict, expected: dict) -> dict:
    """The solution's largest gap from the reference's over the reference's
    largest magnitude, and the gap in iterations taken."""
    x = answer["x"].to(expected["x"].device, torch.float64)
    return {"x_err": float((x - expected["x"]).abs().max() / expected["x"].abs().max()),
            "iters_gap": float(abs(answer["iters"] - expected["iters"]))}
