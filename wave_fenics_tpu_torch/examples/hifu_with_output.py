"""A short planar HIFU solve with its outputs: a probe time series (CSV),
a ParaView time series of the full fields and the acoustic energy, on the
card (or the CPU).

Run: python -m wave_fenics_tpu_torch.examples.hifu_with_output [outdir]
         [--device cuda|cpu] [--steps N]   (default: the case's full count)
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.dofmap import StructuredDofGrid
from ..core.io import write_xdmf_time_series
from ..models.diagnostics import energy
from ..models.linear_wave import solve_recording
from ..models.planar3d import planar3d_case
from ..solvers.rk4 import rk4_solve_n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default="hifu_demo_out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    dtype = torch.float32 if args.device == "cuda" else torch.float64
    case = planar3d_case(ncells=(16, 2, 2), domain_length=6.0e-3, dtype=dtype,
                         device=args.device)
    m = case.model
    dg = StructuredDofGrid(m.mesh, m.p)
    coords = tuple(dg.axis_coords(d) for d in range(3))
    nsteps = case.nsteps if args.steps is None else min(args.steps, case.nsteps)

    # probe time series at 3 stations (kernel F in f1 on a card)
    points = np.array([[1.5e-3, 0, 0], [3.0e-3, 0, 0], [4.5e-3, 0, 0]])
    u, v, series = solve_recording(m, case.t0, case.dt, nsteps, points)
    ts = case.t0 + case.dt * np.arange(1, nsteps + 1)
    np.savetxt(os.path.join(args.outdir, "probes.csv"),
               np.column_stack([ts, series.cpu().numpy()]),
               delimiter=",", header="t,p1,p2,p3", comments="")

    # a coarse time series of the full fields: 4 snapshots of a chunked solve
    snaps = []
    uu, vv = m.zero_state()
    t = case.t0
    chunk = nsteps // 4
    for _ in range(4):
        uu, vv = rk4_solve_n(m.f0, m.f1, uu, vv, t, case.dt, chunk)
        t += chunk * case.dt
        snaps.append((t, {"u": uu.cpu().numpy(), "v": vv.cpu().numpy()}))
    write_xdmf_time_series(os.path.join(args.outdir, "fields.xdmf"), coords, snaps)
    print(f"wrote {args.outdir}/probes.csv and {args.outdir}/fields.xdmf ({nsteps} "
          f"steps, {m.ops.ndofs} dofs); energy at the end "
          f"{float(energy(m, u, v)):.6e}")


if __name__ == "__main__":
    main()
