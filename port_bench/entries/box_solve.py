"""The planar3d box solve as the app runs it: the case and its padded model
from ``apps/planar3d_app.py::build``, the solver from ``solver_path`` (the
traffic's ``integrator``), the app's dt and step count
(leapfrog: dt x 0.71 and ceil(n / 0.71) steps). One solve runs from t0 = 0
to tf from an input state (u0, v0) and returns its final state."""

from __future__ import annotations

import math
import time

import torch

from port_bench.inputs import DTYPES

__all__ = ["Entry"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Entry:
    def __init__(self, config: dict, traffic: dict, device):
        from wave_fenics_tpu_torch.apps import planar3d_app
        from wave_fenics_tpu_torch.ops import _cuda

        self.dev = torch.device(device)
        if self.dev.type == "cuda":
            _cuda.library()  # builds the kernels once per checkout, else loads them
        t = time.perf_counter()
        self.case, self.pm = planar3d_app.build(
            config["cells"], config["degree"], config["dtype"], None, str(self.dev))
        _sync(self.dev)
        self.build_s = time.perf_counter() - t
        self.path, self.solve_fn, _ = planar3d_app.solver_path(
            self.pm, traffic["integrator"])
        self.dt, self.steps = self.case.dt, self.case.nsteps
        if traffic["integrator"] == "leapfrog":
            self.dt *= 0.71
            self.steps = math.ceil(self.steps / 0.71)
        self.dtype = DTYPES[config["dtype"]]
        self.inputs = []

    def load(self, inputs: list[dict]) -> None:
        """The program's form of each input: the state in its padded layout."""
        self.inputs = [tuple(self.pm.from_grid(x[k].to(self.dev, self.dtype))
                             for k in ("u", "v")) for x in inputs]

    def solve(self, u0, v0):
        """One solve: ((u, v), None) and its units of work (steps)."""
        u, v = self.solve_fn(0.0, self.dt, self.steps, u0, v0)
        return ((u, v), None), self.steps

    def answer(self, output) -> dict:
        """The final state on the dof grid."""
        return {k: self.pm.to_grid(x).clone() for k, x in zip(("u", "v"), output[0])}

    def release(self) -> None:
        self.case = self.pm = self.solve_fn = None
        self.inputs = []
