"""The planar3d HIFU application: RK4 on one device.

Port of the single-device RK4 branch of ``wave_fenics_tpu.apps.planar3d_app``
(demo/cpu_planar3d/main.cpp:14-98): build the planar3d case, put it in the
padded layout, run the whole solve through the RK4 step path, and print one
JSON dict with the JAX app's keys plus ``build_seconds`` (the kernel build)
and ``warmup_seconds`` (one step from the initial state), both outside the
solve timer.

Run:
  python -m wave_fenics_tpu_torch.apps.planar3d_app [--cells 64 32 32]
         [--degree 4] [--dtype f32|f64] [--tile-x 48] [--device cuda]
         [--steps N]

``--device cuda`` needs a card and raises without one; ``--device cpu``
runs the plain versions (small grids only). Config files, checkpoints,
XDMF output, leapfrog, sharding and imported meshes are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..models.linear_wave_padded import PaddedLinearWave
from ..models.planar3d import Planar3DCase, planar3d_case
from ..ops import _cuda
from ..ops.rk4step import LAUNCHES_PER_STEP
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
    return case, PaddedLinearWave(case.model, tile_x=tx)


def run(
    cells=(64, 32, 32),
    degree: int = 4,
    dtype: str = "f32",
    tile_x: int | None = None,
    device: str = "cuda",
    steps: int | None = None,
) -> dict:
    case, pm = build(cells, degree, dtype, tile_x, device)
    m = case.model
    dt = case.dt
    nstep = case.nsteps if steps is None else min(steps, case.nsteps)
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
        solver_path = (f"CUDA RK4 stage kernels (csrc/wave_kernels.cu, "
                       f"{LAUNCHES_PER_STEP} launches/step)")
    else:
        solver_path = "plain torch lean RK4 step (CPU)"
    log.info("solver path: %s", solver_path)

    # one step from the initial state, discarded: allocates the kernel's
    # buffers and pays first-launch costs outside the solve timer
    tw = time.perf_counter()
    pm.solve_step_n(case.t0, dt, 1)
    sync(dev)
    warmup_s = time.perf_counter() - tw
    log.info("warmup: %.3f s (excluded from solve time)", warmup_s)

    tm = Timer(dev)
    with tm("solve"):
        u, v, _ = pm.solve_step_n(case.t0, dt, nstep)
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
        "solver_path": solver_path,
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
    args = ap.parse_args(argv)
    out = run(args.cells, args.degree, args.dtype, args.tile_x, args.device,
              args.steps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
