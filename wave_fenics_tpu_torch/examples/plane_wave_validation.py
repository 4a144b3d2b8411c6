"""End-to-end validation: the planar HIFU solve against the analytic plane
wave.

A short two-wavelength domain ((32,2,2) cells over 6 mm, p = 4) in float64,
solved to tf with ``LinearWave.solve`` (kernel F in its stiffness on a
card), and the relative L2 error of u along the x node line against
u(x, t) = p0 sin(w0 (t - x/c0)): the quantitative form of the reference's
offline physics validation. It asserts an error below 1e-6, as the JAX
package's example does (examples/plane_wave_validation.py:23-36).

Run: python -m wave_fenics_tpu_torch.examples.plane_wave_validation
         [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.dofmap import StructuredDofGrid
from ..models.planar3d import analytic_plane_wave, planar3d_case


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    case = planar3d_case(ncells=(32, 2, 2), domain_length=6.0e-3, dtype=torch.float64,
                         device=args.device)
    m = case.model
    print(f"dofs={m.ops.ndofs}  dt={case.dt:.3e}  steps={case.nsteps}")
    u, v, nsteps = m.solve(case.t0, case.tf, case.dt)

    x = StructuredDofGrid(m.mesh, m.p).axis_coords(0)
    u_line = u[:, 0, 0].cpu().numpy()
    u_exact = analytic_plane_wave(x, case.tf, case)
    rel = float(np.linalg.norm(u_line - u_exact) / np.linalg.norm(u_exact))
    print(f"relative L2 error vs analytic plane wave: {rel:.3e}")
    assert rel < 1e-6
    print("PASS")
    return {"ndofs": m.ops.ndofs, "dt": case.dt, "steps": nsteps, "u_line": u_line,
            "rel_err": rel}


if __name__ == "__main__":
    main()
