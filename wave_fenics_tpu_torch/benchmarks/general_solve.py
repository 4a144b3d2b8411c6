"""Unstructured-mesh solve-rate benchmark (GDoF*steps/s), one device.

Port of ``wave_fenics_tpu.benchmarks.general_solve``. The reference's
flagship metric is a wall-clock RK4 solve on an imported mesh
(demo/cpu_planar3d/main.cpp:85-93); this records the explicit-dofmap path:
a deterministically perturbed (genuinely unstructured) hex box driven
through ``GeneralLinearWave``, kernel K on a card (four stiffness applies
per RK4 step; one per leapfrog step and one at t0).

The timestep follows the app's CFL rule dt = CFL h / (c0 p^2)
(demo/cpu_planar3d/main.cpp:61-66) on the smallest cell edge of the
perturbed mesh; leapfrog takes 0.71 of it. Timing: ``reps`` back-to-back
solves of ``steps`` steps (``common.two_point_time``; CUDA events on a
card), then one more solve whose final |v| must be finite, nonzero and
below 1e15 (a divergence passes 1e15 within a few steps).

Run: python -m wave_fenics_tpu_torch.benchmarks.general_solve [--size 16 |
     --s 16] [--degree 4] [--steps 100] [--integrator rk4|leapfrog]
"""

from __future__ import annotations

import time

import numpy as np

from ..core.mesh import HEX_FACES, HexMesh, box_mesh
from ..models.general_wave import GeneralLinearWave
from ..utils.timing import sync
from .common import (bench_dtype, cells_from_args, device_name, make_parser, report,
                     resolve_device, two_point_time)

#: leapfrog's stable step against RK4's (imaginary-axis stability 2 vs 2.83)
LEAPFROG_DT = 0.71


def min_edge(hm: HexMesh) -> float:
    """The smallest cell edge of the mesh (the reference's mesh::h min
    reduction for the CFL rule, demo/cpu_planar3d/main.cpp:47-58)."""
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6),
             (5, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
    pts = hm.points
    return min(float(np.linalg.norm(pts[hm.cells[:, a]] - pts[hm.cells[:, b]],
                                    axis=1).min()) for a, b in edges)


def perturbed_box(cells, h=0.002, amp_rel=0.08, seed=0) -> tuple[HexMesh, dict]:
    """A hex box with structured connectivity and unstructured geometry:
    every interior vertex jittered by ``amp_rel * h`` (seeded). Returns
    (HexMesh, facet_tags) with tag 1 = the x-low source plane, tag 2 = the
    x-high absorbing plane (forms.ufl:21-24), each facet in basix order,
    listed cell by cell."""
    ext = np.asarray(cells, np.float64) * h
    rng = np.random.default_rng(seed)
    hm = box_mesh(tuple(cells), tuple(ext)).to_hex_mesh()
    pts = hm.points.copy()
    inner = np.all((pts > 1e-12) & (pts < ext - 1e-12), axis=1)
    pts[inner] += amp_rel * h * rng.standard_normal(pts[inner].shape)
    hm = HexMesh(points=pts, cells=hm.cells)
    faces = hm.cells[:, HEX_FACES]  # [nc, 6, 4]

    def xface_quads(x0):
        on = np.abs(hm.points[:, 0] - x0) < 1e-12
        return faces[on[faces].all(axis=-1)]

    return hm, {1: xface_quads(0.0), 2: xface_quads(ext[0])}


def build(cells, degree: int = 4, dtype: str = "f32",
          device: str = "cuda") -> tuple[GeneralLinearWave, float]:
    """(the model on the perturbed box of ``cells``, the seconds its set-up
    took: the mesh on the host; the dofmap, geometry, lumped mass and
    boundary weights on ``device``, synchronised before the clock is read)."""
    t0 = time.perf_counter()
    hm, tags = perturbed_box(tuple(cells), h=0.002)
    dev = resolve_device(device)
    model = GeneralLinearWave(hm, degree, tags, dtype=bench_dtype(dtype), device=dev)
    sync(dev)
    return model, time.perf_counter() - t0


def run(size: int = 16, degree: int = 4, s: int | None = None, steps: int = 100,
        cfl: float = 0.5, integrator: str = "rk4", dtype: str = "f32",
        device: str = "cuda", reps: int = 3,
        model: GeneralLinearWave | None = None) -> dict:
    """One solve-rate record (the JAX bench's keys, plus ``device``,
    ``timing``, ``solves``: the solves run, each of ``applies_per_solve``
    stiffness applies, and ``setup_s``: the set-up seconds of ``build``). ``model``
    (optional) is one that ``build`` made for the same arguments."""
    if integrator not in ("rk4", "leapfrog"):
        raise ValueError(f"unknown integrator: {integrator!r}")
    setup_s = None
    if model is None:
        model, setup_s = build(cells_from_args(size, s), degree, dtype, device)
    md = model
    dev = md.device
    # CFL on the actual smallest edge: the jitter shrinks the stable dt
    dt = cfl * min_edge(md.mesh) / (md.c0 * md.p * md.p)
    if integrator == "leapfrog":
        dt *= LEAPFROG_DT

    def solve():
        return md.solve_n(0.0, dt, steps, integrator=integrator)

    t, timing, calls = two_point_time(solve, reps, dev)
    _, v = solve()
    vmax = float(v.abs().max())
    if not (0.0 < vmax < 1e15 and np.isfinite(vmax)):
        raise RuntimeError(f"solve unstable or silent (vmax={vmax:.3e})")
    label = "RK4" if integrator == "rk4" else "leapfrog"
    return {
        "metric": f"general {label} solve (unstructured, GDoF*steps/s)",
        "degree": md.p, "ncells": md.mesh.ncells, "ndofs": md.ndofs,
        "steps": steps, "dt": dt, "integrator": integrator, "dtype": dtype,
        "device": device_name(dev), "ms_per_step": t / steps * 1e3,
        "gdof_steps_per_s": md.ndofs * steps / t / 1e9, "timing": timing,
        "solves": calls + 1,
        "applies_per_solve": 4 * steps if integrator == "rk4" else steps + 1,
        "affine": md.ops.affine, "setup_s": setup_s, "vmax": vmax,
    }


def main(argv=None):
    ap = make_parser(size=16, degree=4, reps=3)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cfl", type=float, default=0.5)
    ap.add_argument("--integrator", choices=["rk4", "leapfrog"], default="rk4",
                    help="'leapfrog': one stiffness apply per step (2nd order, "
                         "dt x 0.71); 'rk4': the reference's")
    args = ap.parse_args(argv)
    report(**run(size=args.size, degree=args.degree, s=args.s, steps=args.steps,
                 cfl=args.cfl, integrator=args.integrator, dtype=args.dtype,
                 device=args.device, reps=args.reps))


if __name__ == "__main__":
    main()
