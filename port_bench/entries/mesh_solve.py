"""The planar3d wave on an imported hex mesh as the app's imported-mesh
branch runs it: a ``HexMesh`` of the configuration's jittered vertex
lattice (``meshes.py``) and its facet tags {1: the faces x = 0, 2: the
faces x = L}, as an XDMF reader hands them over; ``GeneralLinearWave``
(its set-up on the card), ``planar3d.general_case`` (the CFL step on the
mesh's smallest cell diameter) and ``planar3d_app.general_solver_path``
(kernel K). One solve runs RK4 from t0 = 0 for the case's steps from an
input state (u0, v0) and returns its final state.

The inputs and the answers live on the node lattice; the program's state
is a flat vector in its own dof numbering. Cell (cx, cy, cz)'s local node
(a, b, c) is lattice node (p cx + a, p cy + b, p cz + c), so the
program's dofmap gives each lattice node its dof: a one-to-one map,
checked once when the entry is built."""

from __future__ import annotations

import math
import time

import torch

from port_bench import meshes
from port_bench.inputs import DTYPES

__all__ = ["Entry"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Entry:
    def __init__(self, config: dict, traffic: dict, device):
        from wave_fenics_tpu_torch.apps import planar3d_app
        from wave_fenics_tpu_torch.core.mesh import HexMesh
        from wave_fenics_tpu_torch.models import planar3d
        from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave
        from wave_fenics_tpu_torch.ops import _cuda

        if traffic["integrator"] != "rk4":
            raise ValueError(f"integrator {traffic['integrator']!r}: rk4 only")
        self.dev = torch.device(device)
        if self.dev.type == "cuda":
            _cuda.library()  # builds the kernels once per checkout, else loads them
        cells, p = tuple(config["cells"]), config["degree"]
        mesh = HexMesh(points=meshes.vertex_lattice(config).reshape(-1, 3),
                       cells=meshes.hex_cells(cells))
        tags = {1: meshes.x_facets(cells, 0), 2: meshes.x_facets(cells, 1)}
        self.dtype = DTYPES[config["dtype"]]
        t = time.perf_counter()
        self.model = GeneralLinearWave(
            mesh, p, tags, c0=config["c0"], freq0=config["f0"], p0=config["p0"],
            alpha=config["alpha"], dtype=self.dtype, device=self.dev)
        _sync(self.dev)
        self.build_s = time.perf_counter() - t
        self.case = planar3d.general_case(self.model, config["cfl"], config["tail_periods"])
        self.path, self.solve_fn, _ = planar3d_app.general_solver_path(self.model, "rk4")
        self.dt, self.steps = self.case.dt, self.case.nsteps

        self.shape = tuple(n * p + 1 for n in cells)
        nodes = torch.as_tensor(meshes.node_lattice_index(cells, p), device=self.dev)
        dofmap = torch.as_tensor(self.model.dofs.dofmap, device=self.dev).long()
        n = math.prod(self.shape)
        dof = torch.full((n,), -1, dtype=torch.long, device=self.dev)
        dof[nodes.reshape(-1)] = dofmap.reshape(-1)
        seen = torch.zeros(self.model.ndofs, dtype=torch.long, device=self.dev)
        seen.index_add_(0, dof.clamp(min=0), torch.ones_like(dof))
        if (self.model.ndofs != n or not bool((dof[nodes] == dofmap).all())
                or not bool((seen == 1).all())):
            raise ValueError("the program's dofs are not the node lattice's one to one")
        #: the dof of each lattice node, and the lattice node of each dof
        self.dof = dof
        self.node = torch.empty_like(dof)
        self.node[dof] = torch.arange(n, device=self.dev)
        self.inputs = []

    def load(self, inputs: list[dict]) -> None:
        """The program's form of each input: the state in its dof numbering."""
        self.inputs = [tuple(x[k].to(self.dev, self.dtype).reshape(-1)[self.node]
                             for k in ("u", "v")) for x in inputs]

    def solve(self, u0, v0):
        """One solve: ((u, v), None) and its units of work (steps)."""
        u, v = self.solve_fn(0.0, self.dt, self.steps, u0, v0)
        return ((u, v), None), self.steps

    def answer(self, output) -> dict:
        """The final state on the node lattice."""
        return {k: x[self.dof].view(self.shape) for k, x in zip(("u", "v"), output[0])}

    def release(self) -> None:
        self.model = self.case = self.solve_fn = None
        self.inputs = []
