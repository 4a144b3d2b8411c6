"""A distributed solve on an imported (unstructured) hex mesh.

The reference's whole workflow (demo/cpu_planar3d/main.cpp:39-45 and
gpu_scatter_mpi's VectorUpdater) on the port: a perturbed (6,4,4)-cell hex
mesh (12 x 8 x 8 mm, interior vertices jittered by 0.4 mm, seeded) with
tagged source and absorbing x faces, p = 4, float64, on n RCB parts
(``ShardedGeneralWave``: kernel K on each part's tables on a card, the
interface assembled a stage), 10 RK4 steps against the one-device solve.
It asserts a relative difference below 1e-12, as the JAX package's example
does (examples/unstructured_distributed_solve.py:36-69). Every part lives
on the one device through ``halo.LocalExchange``. The JAX example prints
whether its TPU windowed route ran (``fused_kernel``); this prints the
route the parts' matvec took: ``kernel K`` on a card, ``plain`` on the CPU.

Run: python -m wave_fenics_tpu_torch.examples.unstructured_distributed_solve [n]
         [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.mesh import HEX_FACES, HexMesh, box_mesh
from ..models.general_wave import GeneralLinearWave
from ..ops import general
from ..parallel.sharded_general import ShardedGeneralWave

EXT = np.array([0.012, 0.008, 0.008])


def perturbed_mesh() -> tuple[HexMesh, dict]:
    """(the mesh, its facet tags: 1 the x-low faces, 2 the x-high faces)."""
    rng = np.random.default_rng(0)
    hm = box_mesh((6, 4, 4), tuple(EXT)).to_hex_mesh()
    pts = hm.points.copy()
    inner = np.all((pts > 1e-12) & (pts < EXT - 1e-12), axis=1)
    pts[inner] += 4e-4 * rng.standard_normal(pts[inner].shape)
    hm = HexMesh(points=pts, cells=hm.cells)

    def xface_quads(x0):
        on = np.abs(hm.points[:, 0] - x0) < 1e-12
        faces = hm.cells[:, HEX_FACES].reshape(-1, 4)
        return faces[on[faces].all(axis=1)]

    return hm, {1: xface_quads(0.0), 2: xface_quads(EXT[0])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=8, help="parts (default 8)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    hm, tags = perturbed_mesh()
    md = GeneralLinearWave(hm, 4, tags, dtype=torch.float64, device=args.device)
    dt = 1e-9
    sw = ShardedGeneralWave(md, args.n)
    launches = general.general_apply_cuda.launches
    _, v, nsteps = sw.solve_n(0.0, dt, 10)
    route = "kernel K" if general.general_apply_cuda.launches > launches else "plain"
    _, v1 = md.solve_n(0.0, dt, 10)
    vg, v1 = sw.to_global(v), v1.cpu().numpy()
    err = float(np.abs(vg - v1).max() / np.abs(v1).max())
    print(f"ndev={args.n} ndofs={md.ndofs} steps={nsteps} route={route} "
          f"|v|max={float(np.abs(vg).max()):.3e} rel_err_vs_single={err:.2e}")
    assert err < 1e-12
    return {"ndev": args.n, "ndofs": md.ndofs, "steps": nsteps, "route": route,
            "v": vg, "rel_err": err}


if __name__ == "__main__":
    main()
