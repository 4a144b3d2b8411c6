"""The planar3d HIFU application on one device: RK4 or leapfrog.

Port of the single-device structured branch of
``wave_fenics_tpu.apps.planar3d_app`` (demo/cpu_planar3d/main.cpp:14-98):
build the planar3d case, put it in the padded layout, run the whole solve
through the fastest solver path that applies, and print one JSON dict with
the JAX app's keys plus ``integrator``, the ``dt`` it stepped with,
``build_seconds`` (the kernel build) and ``warmup_seconds`` (one kernel
call from the initial state), the last two outside the solve timer.

The path is chosen by applicability, in the JAX app's order, never by
catching a failure:

- RK4: the step kernel (A, or C with ``--full-tableau``) where its slab
  halo fits the tile; else the stage kernel D where the x-face planes
  exist; else RK4 on ``f1`` (kernel B);
- leapfrog (dt x 0.71, ceil(nsteps / 0.71) steps): the 2-step kernel I
  (kernel H for an odd last step); else the step kernel H; else
  ``solvers/leapfrog.py`` on ``force`` (kernel B).

Run:
  python -m wave_fenics_tpu_torch.apps.planar3d_app [--cells 64 32 32]
         [--degree 4] [--dtype f32|f64] [--tile-x 48] [--device cuda]
         [--steps N] [--integrator rk4|leapfrog] [--full-tableau]

``--device cuda`` needs a card and raises without one; ``--device cpu``
runs the plain versions (small grids only). Config files, checkpoints,
XDMF output, sharding and the app's imported-mesh branch (``--mesh``) are
not ported yet; imported meshes run through ``models.general_wave``.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from ..models.linear_wave_padded import PaddedLinearWave
from ..models.planar3d import Planar3DCase, planar3d_case
from ..ops import _cuda
from ..solvers.leapfrog import leapfrog_solve_n
from ..utils.logging import device_info, get_logger, progress
from ..utils.timing import Timer, sync

log = get_logger("planar3d")

_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def build(
    cells=(64, 32, 32),
    degree: int = 4,
    dtype: str = "f32",
    tile_x: int | None = None,
    device: str = "cuda",
    lean: bool = True,
) -> tuple[Planar3DCase, PaddedLinearWave]:
    """The planar3d case and its padded model on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA card is available")
    case = planar3d_case(
        ncells=tuple(cells), domain_length=0.1, degree=degree,
        dtype=_DTYPES[dtype], device=dev,
    )
    # tile 48 at p=4, as the JAX app; the port keeps its layout unchanged
    tx = tile_x if tile_x is not None else (48 if degree == 4 else 16)
    return case, PaddedLinearWave(case.model, tile_x=tx, lean=lean)


def solver_path(pm: PaddedLinearWave, integrator: str = "rk4"):
    """(name, solve, warm-up steps) of the fastest path that applies to
    ``pm``: ``solve(t0, dt, n) -> (u, v)``. The name says which kernel
    runs (or that the plain versions run, on the CPU)."""
    cuda = pm.base.device.type == "cuda"

    def named(kernel: str, plain: str) -> str:
        return (f"CUDA {kernel} (csrc/wave_kernels.cu)" if cuda
                else f"plain torch {plain} (CPU)")

    def first2(solve):
        return lambda t0, dt, n: solve(t0, dt, n)[:2]

    if integrator == "leapfrog":
        if pm.lf2_unavailable is None:
            return (named("2-step leapfrog kernel I, 3 launches per 2 steps; "
                          "kernel H for an odd last step",
                          "2-step leapfrog"), first2(pm.solve_lf2_n), 2)
        if pm.lf_unavailable is None:
            return (named("leapfrog step kernel H, 2 launches/step",
                          "leapfrog step"), first2(pm.solve_lf_n), 1)
        return (named("leapfrog on force = stiffness kernel B",
                      "leapfrog on force"),
                lambda t0, dt, n: leapfrog_solve_n(
                    pm.force, pm.damping, *pm.zero_state(), t0, dt, n), 1)
    if integrator != "rk4":
        raise ValueError(f"integrator {integrator!r}: rk4 or leapfrog")
    if pm.step_unavailable is None:
        if pm.lean:
            name = named("RK4 step kernel A, 4 stage launches/step",
                         "lean RK4 step")
        else:
            name = named("full-tableau RK4 step kernel C, 4 stage launches/step",
                         "full-tableau RK4 step")
        return name, first2(pm.solve_step_n), 1
    if pm.stage_unavailable is None:
        return (named("RK4 stage kernel D, 4 launches/step", "fused RK4 stage"),
                first2(pm.solve_fused_n), 1)
    return (named("RK4 on f1 = stiffness kernel B, 4 launches/step",
                  "RK4 on f1"), pm.solve_n, 1)


def run(
    cells=(64, 32, 32),
    degree: int = 4,
    dtype: str = "f32",
    tile_x: int | None = None,
    device: str = "cuda",
    steps: int | None = None,
    integrator: str = "rk4",
    lean: bool = True,
) -> dict:
    case, pm = build(cells, degree, dtype, tile_x, device, lean)
    m = case.model
    dt = case.dt
    nstep = case.nsteps
    if integrator == "leapfrog":
        # leapfrog's imaginary-axis stability interval is 2 against RK4's
        # 2.83; the case's CFL dt targets RK4
        dt *= 0.71
        nstep = math.ceil(nstep / 0.71)
        log.info("integrator: leapfrog (1 stiffness apply/step, dt*0.71)")
    if steps is not None:
        nstep = min(steps, nstep)
    dev = m.device

    log.info("devices:\n%s", device_info())
    log.info("Number of steps per period: %d", case.steps_per_period)
    log.info("dt = %.8e", dt)
    log.info("Number of steps: %d", nstep)
    log.info("Degrees of freedom: %d", m.ops.ndofs)

    build_s = 0.0
    if dev.type == "cuda":
        tb = time.perf_counter()
        _cuda.library()
        build_s = time.perf_counter() - tb
        log.info("kernel build: %.3f s (excluded from solve time)", build_s)
    path, solve, warm_steps = solver_path(pm, integrator)
    log.info("solver path: %s", path)

    # one kernel call from the initial state, discarded: allocates the
    # kernel's buffers and pays first-launch costs outside the solve timer
    tw = time.perf_counter()
    solve(case.t0, dt, warm_steps)
    sync(dev)
    warmup_s = time.perf_counter() - tw
    log.info("warmup: %.3f s (excluded from solve time)", warmup_s)

    tm = Timer(dev)
    with tm("solve"):
        u, v = solve(case.t0, dt, nstep)
    solve_s = tm.seconds("solve")
    progress(nstep, nstep, case.t0 + nstep * dt, every=1)
    log.info("Solve time: %.3f s", solve_s)
    return {
        "ndofs": int(m.ops.ndofs),
        "nsteps": nstep,
        "steps_per_period": case.steps_per_period,
        "solve_seconds": solve_s,
        "gdof_steps_per_s": m.ops.ndofs * nstep / solve_s / 1e9,
        "u_norm": float(torch.linalg.norm(u.float())),
        "solver_path": path,
        "integrator": integrator,
        "dt": dt,
        "build_seconds": build_s,
        "warmup_seconds": warmup_s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, nargs=3, default=(64, 32, 32))
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="f32")
    ap.add_argument("--tile-x", type=int, default=None,
                    help="padded-layout x tile (default 48 at p=4, else 16)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=None,
                    help="cap on the number of steps (default: the case's "
                         "full nsteps)")
    ap.add_argument("--integrator", choices=("rk4", "leapfrog"), default="rk4",
                    help="leapfrog: 1 stiffness apply/step, 2nd order, dt "
                         "scaled by 0.71")
    ap.add_argument("--full-tableau", action="store_true",
                    help="RK4 step kernel with the full Butcher tableau "
                         "(kernel C) instead of the lean stage algebra")
    args = ap.parse_args(argv)
    out = run(args.cells, args.degree, args.dtype, args.tile_x, args.device,
              args.steps, args.integrator, not args.full_tableau)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
