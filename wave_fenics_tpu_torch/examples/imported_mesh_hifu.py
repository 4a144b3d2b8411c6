"""The imported-mesh workflow in one script, on the card (or the CPU):

1. write a demo XDMF mesh and its facet meshtags (a stand-in for a
   DOLFINx export; tag 1 = source plane, tag 2 = absorbing,
   forms.ufl:21-24), binary heavy data;
2. ``from_xdmf`` -> ``GeneralLinearWave`` (explicit dofmap; kernel K on a
   card);
3. solve with probe recording (hydrophone time series, sampled on the
   device);
4. write the final field as a p-refined sub-hex XDMF for ParaView.

Run: python -m wave_fenics_tpu_torch.examples.imported_mesh_hifu [outdir]
         [--device cuda|cpu] [--steps 200]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..benchmarks.general_solve import perturbed_box
from ..core.io import write_xdmf_mesh, write_xdmf_meshtags, write_xdmf_unstructured
from ..models.general_wave import from_xdmf, solve_recording


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default="imported_demo_out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    # -- 1. a demo "imported" mesh: 8x3x3 cells of 2.5 mm, the interior
    # vertices jittered by 0.2 mm (seeded)
    hm, tags = perturbed_box((8, 3, 3), h=0.0025)
    mesh_path = os.path.join(args.outdir, "mesh.xdmf")
    tags_path = os.path.join(args.outdir, "meshtags.xdmf")
    write_xdmf_mesh(mesh_path, hm)
    write_xdmf_meshtags(tags_path, hm, np.concatenate([tags[1], tags[2]]),
                        [1] * len(tags[1]) + [2] * len(tags[2]))

    # -- 2-3. the model and a solve with probes
    dtype = torch.float32 if args.device == "cuda" else torch.float64
    model = from_xdmf(mesh_path, tags_path, p=4, dtype=dtype, device=args.device)
    dt = 0.25 * model.mesh.hmin() / (model.c0 * model.p**2)
    probes = np.array([[0.005, 0.0037, 0.0037], [0.015, 0.0037, 0.0037]])
    # long runs: integrator="leapfrog" costs one stiffness apply per step
    # instead of RK4's four (2nd order; scale dt by about 0.71)
    u, v, series = solve_recording(model, 0.0, dt, args.steps, probes, integrator="rk4")
    series = series.cpu().numpy()
    np.savetxt(os.path.join(args.outdir, "probes.csv"),
               np.column_stack([dt * np.arange(1, args.steps + 1), series]),
               delimiter=",", header="t,p1,p2", comments="")

    # -- 4. ParaView output
    write_xdmf_unstructured(os.path.join(args.outdir, "solution.xdmf"), model.dofs,
                            {"u": u.cpu().numpy(), "v": v.cpu().numpy()},
                            time=args.steps * dt)
    print(f"ndofs={model.ndofs} nsteps={args.steps} |u|max={float(u.abs().max()):.4g} "
          f"probe_pk={np.abs(series).max(axis=0)} -> {args.outdir}/")


if __name__ == "__main__":
    main()
