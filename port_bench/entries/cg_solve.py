"""BP1 CG as the port's ``cg_bench`` runs it: ``ops/mass.py::bp1_setup``
(kernel G on the padded layout), ``mass_apply`` as the matvec and
``solvers/cg.py::cg`` with the configuration's kmax and rtol from x0 = 0,
unpreconditioned. One solve takes a right-hand side b and returns
(x, iterations)."""

from __future__ import annotations

import time

import torch

from port_bench.inputs import DTYPES

__all__ = ["Entry"]


class Entry:
    def __init__(self, config: dict, traffic: dict, device):
        from wave_fenics_tpu_torch.core.mesh import box_mesh
        from wave_fenics_tpu_torch.ops import _cuda
        from wave_fenics_tpu_torch.ops.mass import bp1_setup, mass_apply
        from wave_fenics_tpu_torch.solvers import cg

        self._cg, self._mass_apply = cg, mass_apply
        self.dev = torch.device(device)
        if self.dev.type == "cuda":
            _cuda.library()  # builds the kernels once per checkout, else loads them
        self.dtype = DTYPES[config["dtype"]]
        self.kmax, self.rtol = config["kmax"], config["rtol"]
        L = config["length"]
        t = time.perf_counter()
        mesh = box_mesh(tuple(config["cells"]), (L, L, L))
        # q: the exactness degree of gauss_points Gauss points
        self.layout, self.tables, _ = bp1_setup(
            mesh, config["degree"], self.dtype, self.dev, False,
            q=2 * config["gauss_points"] - 1)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.build_s = time.perf_counter() - t
        self.path = "CG on the BP1 mass (ops/mass.py::mass_apply)"
        self.inputs = []

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._mass_apply(x, self.layout, self.tables)

    def load(self, inputs: list[dict]) -> None:
        """The program's form of each right-hand side: the padded layout."""
        self.inputs = [(self.layout.pad(x["b"].to(self.dev, self.dtype)),) for x in inputs]

    def solve(self, b):
        """One solve: ((x,), iterations) and its units of work (iterations)."""
        x, k, _ = self._cg.cg(self.matvec, b, kmax=self.kmax, rtol=self.rtol)
        return ((x,), k), k

    def answer(self, output) -> dict:
        return {"x": self.layout.unpad(output[0][0]).clone(), "iters": output[1]}

    def release(self) -> None:
        self.layout = self.tables = None
        self.inputs = []
