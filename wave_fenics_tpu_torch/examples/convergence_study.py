"""h- and p-convergence of the planar wave solve.

Prints a table of relative L2 errors against the analytic travelling wave
u(x, t) = p0 sin(w0 (t - x/c0)) for p in {2, 3, 4} and nx in {8, 12, 16}
cells along x ((nx, 1, 1) cells over 4.5 mm, float64, ``LinearWave.solve``
to tf; kernel F on a card): the physics validation as a study (the JAX
package's examples/convergence_study.py:25-42).

Run: python -m wave_fenics_tpu_torch.examples.convergence_study
         [--device cuda|cpu] [--degrees 2 3 4] [--nx 8 12 16]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.dofmap import StructuredDofGrid
from ..models.planar3d import analytic_plane_wave, planar3d_case


def solve_line(nx: int, p: int, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """(u along the x node line at tf, the analytic wave there) of the
    (nx, 1, 1)-cell case of degree p."""
    case = planar3d_case(ncells=(nx, 1, 1), domain_length=4.5e-3, width=4.5e-3 / nx,
                         degree=p, dtype=torch.float64, device=device)
    m = case.model
    u, _, _ = m.solve(case.t0, case.tf, case.dt)
    x = StructuredDofGrid(m.mesh, p).axis_coords(0)
    return u[:, 0, 0].cpu().numpy(), analytic_plane_wave(x, case.tf, case)


def err_for(nx: int, p: int, device="cuda") -> float:
    u, ue = solve_line(nx, p, device)
    return float(np.linalg.norm(u - ue) / np.linalg.norm(ue))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--degrees", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--nx", type=int, nargs="+", default=[8, 12, 16])
    args = ap.parse_args(argv)

    errors = {}
    print(f"{'p \\ nx':>7} " + " ".join(f"{nx:>10}" for nx in args.nx))
    for p in args.degrees:
        row = [err_for(nx, p, args.device) for nx in args.nx]
        errors.update({(p, nx): e for nx, e in zip(args.nx, row)})
        print(f"{p:>7} " + " ".join(f"{e:10.2e}" for e in row))
    return {"errors": errors}


if __name__ == "__main__":
    main()
