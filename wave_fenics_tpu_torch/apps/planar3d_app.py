"""The planar3d HIFU application: RK4 or leapfrog, on a box or on an
imported mesh, on one device or (``--ndev N``, a box) on N blocks.

Port of ``wave_fenics_tpu.apps.planar3d_app`` (demo/cpu_planar3d/
main.cpp:14-98): build the planar3d case from a
``SimulationConfig`` (``utils/config.py``; a JSON file with ``--config``,
the JAX package's format), run the solve in chunks of
``run.checkpoint_every_steps`` with a snapshot after each chunk but the
last when ``--checkpoint-dir`` is given (a later run resumes from the
latest snapshot, ``utils/checkpoint.py``), write the final state as XDMF
with ``--output``, and print one JSON dict with the JAX app's keys plus
``integrator``, the ``dt`` it stepped with, ``build_seconds`` (the kernel
build, also ``compile_seconds``), ``warmup_seconds`` (one step from the
initial state, discarded; the last two outside the solve timer),
``resumed_from_step``, ``setup_seconds`` (the case and its model, host),
``read_seconds`` (reading the mesh files, part of the setup) and
``output_seconds`` (the device-to-host copy and the XDMF write, after the
solve timer stops; 0 without ``--output``).

The box branch puts the case in the padded layout and runs the fastest
solver path that applies, in the JAX app's order, never by catching a
failure:

- RK4: ``--two-step``: the 2-step kernel J (raises where it does not
  apply); else the step kernel (A, or C with ``--full-tableau``) where its
  slab halo fits the tile; else the stage kernel D where the x-face planes
  exist; else RK4 on ``f1`` (kernel B, or kernel E on the 3D-slab layout
  the model takes for p > 8);
- leapfrog (dt x 0.71, ceil(nsteps / 0.71) steps): the 2-step kernel I
  (kernel H for an odd last step); else the step kernel H; else
  ``solvers/leapfrog.py`` on ``force`` (kernel B, or E).

The imported-mesh branch (``--mesh`` and ``--meshtags``, or
``domain.mesh_path``/``meshtags_path``) builds ``planar3d_case_xdmf``, a
``GeneralLinearWave``, and runs ``solve_n`` on kernel K: RK4 with 4
stiffness applies a step, or leapfrog with one a step and one at each
chunk's t0 (the force is re-derived from (t, u) per chunk, which is
exact). ``--cells``, ``--tile-x``, ``--full-tableau`` and ``--two-step``
apply to the box branch and raise with ``--mesh``. ``--output`` writes
``write_xdmf_unstructured`` on the general branch and
``write_xdmf_rectilinear`` of the unpadded grid on the box branch, with
binary heavy data (no h5py needed).

The sharded branch (``--ndev N`` or ``run.ndev``, N > 1) on a box splits
the case into ``decompose3d(N)`` blocks (``parallel/sharded_padded.py``;
on one card every block sits on it) and picks the solver as the JAX app
does, with its ``solver_path`` strings: RK4 on the value-halo step kernel
A where it applies ("sharded value-halo RK4 STEP kernel"), else the
per-stage halo-add on kernel B or E ("sharded per-stage halo-add RK4");
leapfrog on the value-halo kernel H ("sharded value-halo leapfrog STEP
kernel"; raises where it does not apply). On an imported mesh it splits
the cells into N parts by recursive coordinate bisection
(``parallel/sharded_general.py``, the assembly mode ``auto``, reported as
``exchange``) and runs ``solve_n`` with kernel K on each part ("sharded
general (rk4, RCB, ndev=N)", or leapfrog), one warm-up step. Snapshots and
``--output`` hold the global dof grid or vector. ``--full-tableau`` and
``--two-step`` raise with it.

Run:
  python -m wave_fenics_tpu_torch.apps.planar3d_app [--config cfg.json]
         [--checkpoint-dir ckpt] [--cells 64 32 32] [--degree 4]
         [--dtype f32|f64|bf16] [--tile-x 48] [--device cuda] [--steps N]
         [--integrator rk4|leapfrog] [--full-tableau] [--two-step]
         [--output out.xdmf] [--ndev N]
  python -m wave_fenics_tpu_torch.apps.planar3d_app --mesh mesh.xdmf
         [--meshtags tags.xdmf] [--output out.xdmf] [--degree 4]
         [--integrator rk4|leapfrog] [...]

Flags given on the command line override the config file. ``--device cuda``
needs a card and raises without one; ``--device cpu`` runs the plain
versions (small grids only), its blocks too with ``--ndev``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..convert import to_numpy
from ..core.dofmap import StructuredDofGrid
from ..core.io import write_xdmf_rectilinear, write_xdmf_unstructured
from ..models.general_wave import GeneralLinearWave
from ..models.linear_wave_padded import PaddedLinearWave
from ..models.planar3d import Planar3DCase, planar3d_case
from ..ops import _cuda
from ..parallel.partition import decompose3d
from ..parallel.sharded_general import ShardedGeneralWave
from ..parallel.sharded_padded import ShardedPaddedWave
from ..solvers.leapfrog import leapfrog_solve_n
from ..utils.checkpoint import CheckpointManager
from ..utils.config import DTYPES, SimulationConfig
from ..utils.logging import device_info, get_logger, progress
from ..utils.timing import Timer, sync

log = get_logger("planar3d")

#: logged by every bf16 run of the box, on one device or on blocks (which
#: hold one device's tables): bf16 tables give the stencil's rows a nonzero
#: sum, so a constant mode grows from some hundreds of steps on; the JAX
#: package's bf16 solve_n grows the same way. K's bf16 stiffness (an
#: imported mesh) keeps -c0^2 <1, K 1> / sum(m) below zero (apps/bf16_growth.py
#: --general), so no mode grows and that branch logs BF16_NOTE instead
BF16_WARNING = ("bf16 state: the stiffness tables rounded to bf16 no longer sum to "
                "zero along a row, and the solution grows over long runs (as the "
                "JAX package's bf16 solve_n does); check the answer against an f32 "
                "run")
BF16_NOTE = ("bf16 state: tables and fields rounded to bf16 (f32 arithmetic); check "
             "the answer against an f32 run")


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA card is available")
    return dev


def padded_model(case: Planar3DCase, tile_x: int | None = None,
                 lean: bool = True) -> PaddedLinearWave:
    """The case's model in the padded layout: tile 48 at p=4, as the JAX
    app, else 16; the port keeps the layout unchanged."""
    tx = tile_x if tile_x is not None else (48 if case.model.p == 4 else 16)
    return PaddedLinearWave(case.model, tile_x=tx, lean=lean)


def build(
    cells=(64, 32, 32),
    degree: int = 4,
    dtype: str = "f32",
    tile_x: int | None = None,
    device: str = "cuda",
    lean: bool = True,
) -> tuple[Planar3DCase, PaddedLinearWave]:
    """The planar3d case and its padded model on ``device``."""
    case = planar3d_case(
        ncells=tuple(cells), domain_length=0.1, degree=degree,
        dtype=DTYPES[dtype], device=_device(device),
    )
    return case, padded_model(case, tile_x, lean)


def solver_path(pm: PaddedLinearWave, integrator: str = "rk4",
                two_step: bool = False):
    """(name, solve, warm-up steps) of the fastest path that applies to
    ``pm``: ``solve(t0, dt, n, u0=None, v0=None) -> (u, v)`` from (u0, v0),
    or from the zero state. The name says which kernel runs (or that the
    plain versions run, on the CPU). ``two_step`` asks for kernel J and
    raises where it does not apply."""
    cuda = pm.base.device.type == "cuda"
    stiffness = "kernel E" if pm.kernel == "3d" else "kernel B"

    def named(kernel: str, plain: str) -> str:
        src = ("csrc/slab_tiled.cu" if "kernel E" in kernel
               else "csrc/rk4_tiled.cu, csrc/rk42_tiled.cu" if "kernel J" in kernel
               else "csrc/rk4_tiled.cu" if "kernel A" in kernel or "kernel C" in kernel
               else "csrc/rk_stage_tiled.cu" if "kernel D" in kernel
               else "csrc/lf_tiled.cu" if "kernel H" in kernel or "kernel I" in kernel
               else "csrc/flat_tiled.cu")
        bf16 = ", bf16 state" if pm.base.dtype == torch.bfloat16 else ""
        return (f"CUDA {kernel} ({src}){bf16}" if cuda
                else f"plain torch {plain} (CPU){bf16}")

    def kernel_solve(solve):
        return lambda t0, dt, n, u0=None, v0=None: solve(t0, dt, n, u0, v0)[:2]

    def state(u0, v0):
        return pm.zero_state() if u0 is None else (u0, v0)

    if two_step:
        if integrator != "rk4":
            raise ValueError(
                "--two-step selects the 2-step RK4 kernel J; leapfrog already "
                "runs two steps per call of kernel I")
        pm._require(pm.rk42_unavailable, "--two-step: fused 2-step RK4 kernel")
        tail = "A" if pm.lean else "C"
        return (named(f"2-step RK4 kernel J, 7 launches per 2 steps; kernel "
                      f"{tail} for an odd last step", "2-step RK4"),
                kernel_solve(pm.solve_step2_n), 2)
    if integrator == "leapfrog":
        if pm.lf2_unavailable is None:
            return (named("2-step leapfrog kernel I, 3 launches per 2 steps; "
                          "kernel H for an odd last step",
                          "2-step leapfrog"), kernel_solve(pm.solve_lf2_n), 2)
        if pm.lf_unavailable is None:
            return (named("leapfrog step kernel H, 2 launches/step",
                          "leapfrog step"), kernel_solve(pm.solve_lf_n), 1)
        return (named(f"leapfrog on force = stiffness {stiffness}",
                      "leapfrog on force"),
                lambda t0, dt, n, u0=None, v0=None: leapfrog_solve_n(
                    pm.force, pm.damping, *state(u0, v0), t0, dt, n), 1)
    if integrator != "rk4":
        raise ValueError(f"integrator {integrator!r}: rk4 or leapfrog")
    if pm.step_unavailable is None:
        if pm.lean:
            name = named("RK4 step kernel A, 4 stage launches/step",
                         "lean RK4 step")
        else:
            name = named("full-tableau RK4 step kernel C, 4 stage launches/step",
                         "full-tableau RK4 step")
        return name, kernel_solve(pm.solve_step_n), 1
    if pm.stage_unavailable is None:
        return (named("RK4 stage kernel D, 4 launches/step", "fused RK4 stage"),
                kernel_solve(pm.solve_fused_n), 1)
    return (named(f"RK4 on f1 = stiffness {stiffness}, 4 launches/step",
                  "RK4 on f1"),
            lambda t0, dt, n, u0=None, v0=None: pm.solve_n(
                t0, dt, n, *state(u0, v0)), 1)


def general_solver_path(model: GeneralLinearWave, integrator: str = "rk4"):
    """(name, solve, warm-up steps) of the imported-mesh branch:
    ``GeneralLinearWave.solve_n`` on kernel K (its plain version on the
    CPU), with ``solve(t0, dt, n, u0=None, v0=None) -> (u, v)``."""
    label, per_step = (("general RK4", "4 applies/step") if integrator == "rk4" else
                       ("general leapfrog", "1 apply/step and 1 at each call's t0"))
    name = (f"CUDA kernel K (csrc/general_kernels.cu): {label}, {per_step}"
            if model.device.type == "cuda"
            else f"plain torch {label} on kernel K's plain version (CPU)")

    def solve(t0, dt, n, u0=None, v0=None):
        return model.solve_n(t0, dt, n, u0, v0, integrator=integrator)

    return name, solve, 1


def sharded_solver_path(sw: ShardedPaddedWave, integrator: str = "rk4"):
    """(name, solve, layout) of the sharded branch, chosen as the JAX app
    chooses it and named with its ``solver_path`` strings: ``solve(t0, dt,
    n, u0=None, v0=None) -> (u, v)`` on the blocks of ``layout``."""
    def blocks_solve(solve):
        return lambda t0, dt, n, u0=None, v0=None: solve(t0, dt, n, u0, v0)[:2]

    if integrator == "leapfrog":
        why = sw.lf_unavailable
        if why is not None:
            raise ValueError("distributed leapfrog needs the value-halo step path "
                             f"({why})")
        return ("sharded value-halo leapfrog STEP kernel", blocks_solve(sw.solve_lf_n),
                sw.halo_layout("lf"))
    if integrator != "rk4":
        raise ValueError(f"integrator {integrator!r}: rk4 or leapfrog")
    if sw.step_unavailable is None:
        return ("sharded value-halo RK4 STEP kernel", blocks_solve(sw.solve_step_n),
                sw.halo_layout("step"))
    return "sharded per-stage halo-add RK4", blocks_solve(sw.solve_n), sw.layout


def sharded_general_solver_path(sg: ShardedGeneralWave, integrator: str = "rk4"):
    """(name, solve) of the sharded imported-mesh branch, named with the JAX
    app's ``solver_path``: ``solve(t0, dt, n, u0=None, v0=None) -> (u, v)``
    on the parts (``ShardedGeneralWave.solve_n``)."""
    if integrator not in ("rk4", "leapfrog"):
        raise ValueError(f"integrator {integrator!r}: rk4 or leapfrog")

    def solve(t0, dt, n, u0=None, v0=None):
        return sg.solve_n(t0, dt, n, u0, v0, integrator=integrator)[:2]

    return f"sharded general ({integrator}, RCB, ndev={sg.ndev})", solve


def sharded_kernels(sw: ShardedPaddedWave, name: str) -> str:
    """What runs on each block of a sharded path (the log's line)."""
    kernel = ("kernel H (csrc/lf_tiled.cu)" if "leapfrog" in name
              else "kernel A (csrc/rk4_tiled.cu)" if "STEP" in name
              else "kernel E (csrc/slab_tiled.cu)" if sw.kernel == "3d"
              else "kernel B (csrc/flat_tiled.cu)")
    where = ("CUDA " + kernel if sw.model.device.type == "cuda"
             else f"the plain version of {kernel} (CPU)")
    return f"{where} on each of {sw.mesh.nblocks} blocks {sw.parts}"


def write_output(path: str, model, pm: PaddedLinearWave | None, u, v, t: float) -> None:
    """Write the final (u, v) at time t as XDMF with binary heavy data: the
    sub-hex grid of a general model, or the rectilinear dof grid of a box
    (the padded state ``pm.to_grid`` first; ``pm`` None on a box: the
    global grid of a sharded run). Fields are tensors or NumPy arrays (the
    global state of a sharded run)."""
    def host(x):  # a bf16 state widened exactly (the writers store float64)
        return x if isinstance(x, np.ndarray) else to_numpy(x)

    if isinstance(model, GeneralLinearWave):
        write_xdmf_unstructured(path, model.dofs, {"u": host(u), "v": host(v)}, time=t)
    else:
        if pm is not None:
            u, v = pm.to_grid(u), pm.to_grid(v)
        dg = StructuredDofGrid(model.mesh, model.p)
        write_xdmf_rectilinear(path, tuple(dg.axis_coords(d) for d in range(3)),
                               {"u": host(u), "v": host(v)}, time=t)


def run(
    cfg: SimulationConfig | None = None,
    *,
    cells=None,
    degree: int | None = None,
    dtype: str | None = None,
    integrator: str | None = None,
    checkpoint_dir: str | None = None,
    tile_x: int | None = None,
    device: str = "cuda",
    steps: int | None = None,
    lean: bool = True,
    two_step: bool = False,
    return_state: bool = False,
    mesh: str | None = None,
    meshtags: str | None = None,
    output: str | None = None,
    ndev: int | None = None,
):
    """Run the planar3d app on ``cfg`` (default ``SimulationConfig()``);
    the keywords ``cells``, ``degree``, ``dtype``, ``integrator``,
    ``checkpoint_dir``, ``mesh``, ``meshtags``, ``output`` and ``ndev``
    override its fields, as the command-line flags do. ``steps`` caps the
    step count. The caller's ``cfg`` is not changed. Returns the JSON dict,
    or (dict, u, v) with the final state (padded on a box, flat on an
    imported mesh, the blocks of a sharded run) when ``return_state``."""
    cfg = cfg if cfg is not None else SimulationConfig()
    cfg = dataclasses.replace(
        cfg, physics=dataclasses.replace(cfg.physics),
        domain=dataclasses.replace(cfg.domain), time=dataclasses.replace(cfg.time),
        run=dataclasses.replace(cfg.run))
    for value, section, name in ((cells, cfg.domain, "ncells"),
                                 (degree, cfg.domain, "degree"),
                                 (dtype, cfg.run, "dtype"),
                                 (integrator, cfg.time, "integrator"),
                                 (checkpoint_dir, cfg.run, "checkpoint_dir"),
                                 (mesh, cfg.domain, "mesh_path"),
                                 (meshtags, cfg.domain, "meshtags_path"),
                                 (output, cfg.run, "output_path"),
                                 (ndev, cfg.run, "ndev")):
        if value is not None:
            setattr(section, name, tuple(value) if name == "ncells" else value)
    imported = cfg.domain.mesh_path is not None
    sharded = cfg.run.ndev > 1
    if sharded and not imported:
        one_device = [flag for flag, given in (
            ("--full-tableau", not lean), ("--two-step", two_step)) if given]
        if one_device:
            raise ValueError(
                f"{', '.join(one_device)}: one-device options; the sharded branch "
                f"(--ndev {cfg.run.ndev}) runs the lean step kernel A or kernel H")
    if imported:
        box_only = [flag for flag, given in (
            ("--cells", cells is not None), ("--tile-x", tile_x is not None),
            ("--full-tableau", not lean), ("--two-step", two_step)) if given]
        if box_only:
            raise ValueError(
                f"{', '.join(box_only)}: box-branch options (the padded structured "
                "solvers); an imported mesh (--mesh, domain.mesh_path) runs on "
                "kernel K")
    ts = time.perf_counter()
    case = cfg.build_case(device=_device(device))
    pm = None if imported or sharded else padded_model(case, tile_x, lean)
    sw = (ShardedPaddedWave(case.model, decompose3d(cfg.run.ndev),
                            tile_x=tile_x if tile_x is not None else 16)
          if sharded and not imported else None)
    sg = (ShardedGeneralWave(case.model, cfg.run.ndev).prepare() if sharded and imported
          else None)
    m = case.model
    dev = m.device
    sync(dev)  # a general model's set-up runs on the card
    setup_s = time.perf_counter() - ts
    integrator = cfg.time.integrator
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

    log.info("devices:\n%s", device_info())
    log.info("Number of steps per period: %d", case.steps_per_period)
    log.info("dt = %.8e", dt)
    log.info("Number of steps: %d", nstep)
    log.info("Degrees of freedom: %d", m.ops.ndofs)
    log.info("setup: %.3f s (mesh files read in %.3f s)", setup_s, case.read_seconds)

    build_s = 0.0
    if dev.type == "cuda":
        tb = time.perf_counter()
        _cuda.library()
        build_s = time.perf_counter() - tb
        log.info("kernel build: %.3f s (excluded from solve time)", build_s)
    if sg is not None:
        path, solve = sharded_general_solver_path(sg, integrator)
        warm_steps = 1
        log.info("parts: kernel K on each of %d RCB parts, %s assembly", sg.ndev,
                 sg.exchange_mode)
    elif imported:
        path, solve, warm_steps = general_solver_path(m, integrator)
    elif sharded:
        path, solve, lay = sharded_solver_path(sw, integrator)
        warm_steps = 1
        log.info("blocks: %s", sharded_kernels(sw, path))
    else:
        path, solve, warm_steps = solver_path(pm, integrator, two_step)
    log.info("solver path: %s", path)
    if m.dtype == torch.bfloat16:
        log.warning(BF16_NOTE if imported else BF16_WARNING)

    cm = (CheckpointManager(cfg.run.checkpoint_dir, cfg.run.checkpoint_every_steps)
          if cfg.run.checkpoint_dir else None)
    t = case.t0
    step0 = 0
    u = v = None
    if cm is not None:
        snap = cm.restore()
        if snap is not None:
            step0, u_np, v_np, t, _ = snap
            if isinstance(u_np, torch.Tensor) != (m.dtype == torch.bfloat16):
                raise ValueError(f"a snapshot of {getattr(u_np, 'dtype', None)} in "
                                 f"{cfg.run.checkpoint_dir}: a bf16 run resumes "
                                 "only from a bf16 snapshot, and a bf16 snapshot "
                                 "only into a bf16 run")
            u = torch.as_tensor(u_np, dtype=m.dtype, device=dev)
            v = torch.as_tensor(v_np, dtype=m.dtype, device=dev)
            if imported and tuple(u.shape) != (m.ndofs,):
                raise ValueError(f"snapshot of shape {tuple(u.shape)} in "
                                 f"{cfg.run.checkpoint_dir}: the imported mesh has "
                                 f"{m.ndofs} dofs")
            if sg is not None:
                u, v = sg.from_global(u), sg.from_global(v)
            elif sharded:
                if tuple(u.shape) != m.ops.grid_shape:
                    raise ValueError(f"snapshot of shape {tuple(u.shape)} in "
                                     f"{cfg.run.checkpoint_dir}: a sharded run resumes "
                                     f"from the global grid {m.ops.grid_shape}")
                u, v = sw.from_global(to_numpy(u), lay), sw.from_global(to_numpy(v), lay)
            elif not imported and tuple(u.shape) != pm.layout.padded_shape:
                # a snapshot on the unpadded grid
                u, v = pm.from_grid(u), pm.from_grid(v)
            log.info("resumed from step %d (t=%.6e)", step0, t)
    chunk = cfg.run.checkpoint_every_steps if cm is not None else max(nstep, 1)

    def to_global(x):
        """A sharded state on the host: the global vector or dof grid."""
        return sg.to_global(x) if sg is not None else sw.to_global(x, lay)

    def snapshot(x):
        """A sharded state as a snapshot holds it: the global vector or dof
        grid (a bf16 state as a bf16 tensor, exact from its float32 gather)."""
        g = to_global(x)
        return torch.as_tensor(g).to(m.dtype) if m.dtype == torch.bfloat16 else g

    # one kernel call (one step; two for kernel J) from the initial state,
    # discarded: allocates the kernel's buffers and pays first-launch costs
    # outside the solve timer
    tw = time.perf_counter()
    solve(case.t0, dt, warm_steps)
    sync(dev)
    warmup_s = time.perf_counter() - tw
    log.info("warmup: %.3f s (excluded from solve time)", warmup_s)

    tm = Timer(dev)
    step = step0
    with tm("solve"):
        while step < nstep:
            n = min(chunk, nstep - step)
            u, v = solve(t, dt, n, u, v)
            step += n
            t = t + n * dt
            progress(step, nstep, t, every=1)
            if cm is not None and step < nstep:
                if sharded:  # snapshots hold the global grid or vector
                    cm.save(step, snapshot(u), snapshot(v), t)
                else:
                    cm.save(step, u, v, t)
    solve_s = tm.seconds("solve")
    log.info("Solve time: %.3f s", solve_s)
    if u is None:  # nothing to run: the initial state
        u, v = (sg.zero_state() if sg is not None else m.zero_state() if imported else
                (sw.zero_blocks(lay), sw.zero_blocks(lay)) if sharded else pm.zero_state())
    output_s = 0.0
    if sharded:
        u_glob = to_global(u)
    if cfg.run.output_path:
        to = time.perf_counter()
        if sharded:
            write_output(cfg.run.output_path, m, None, u_glob, to_global(v), t)
        else:
            write_output(cfg.run.output_path, m, pm, u, v, t)
        output_s = time.perf_counter() - to
        log.info("wrote %s in %.3f s", cfg.run.output_path, output_s)
    out = {
        "ndofs": int(m.ops.ndofs),
        "nsteps": nstep,
        "steps_per_period": case.steps_per_period,
        "solve_seconds": solve_s,
        "gdof_steps_per_s": (m.ops.ndofs * (nstep - step0) / solve_s / 1e9
                             if solve_s > 0 else 0.0),
        "u_norm": (float(np.linalg.norm(u_glob.astype(np.float32))) if sharded
                   else float(torch.linalg.norm(u.float()))),
        "u_max": (float(np.abs(u_glob).max()) if sharded
                  else float(u.float().abs().max())),
        "solver_path": path,
        "compile_seconds": build_s,
        "warmup_seconds": warmup_s,
        "integrator": integrator,
        "dt": dt,
        "build_seconds": build_s,
        "resumed_from_step": step0,
        "setup_seconds": setup_s,
        "read_seconds": case.read_seconds,
        "output_seconds": output_s,
        "ndev": cfg.run.ndev,
        "dtype": cfg.run.dtype,
    }
    if sg is not None:
        out["exchange"] = sg.exchange_mode
    return (out, u, v) if return_state else out


def parse_args(argv=None) -> tuple[SimulationConfig, dict]:
    """(config, keyword arguments of :func:`run`) from the command line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None,
                    help="a SimulationConfig JSON file (the JAX package's format)")
    ap.add_argument("--mesh", type=str, default=None,
                    help="an XDMF hex mesh (imported-mesh mode, the reference's "
                         "cpu_planar3d workflow; kernel K)")
    ap.add_argument("--meshtags", type=str, default=None,
                    help="its XDMF facet meshtags (tag 1 source, 2 absorbing)")
    ap.add_argument("--output", type=str, default=None,
                    help="write the final u, v as XDMF (binary heavy data)")
    ap.add_argument("--checkpoint-dir", type=str, default=None,
                    help="snapshot after each chunk of run.checkpoint_every_steps "
                         "steps; resume from the latest snapshot there")
    ap.add_argument("--cells", type=int, nargs=3, default=None)
    ap.add_argument("--degree", type=int, default=None)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None)
    ap.add_argument("--tile-x", type=int, default=None,
                    help="padded-layout x tile (default 48 at p=4, else 16)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=None,
                    help="cap on the number of steps (default: the case's "
                         "full nsteps)")
    ap.add_argument("--integrator", choices=("rk4", "leapfrog"), default=None,
                    help="leapfrog: 1 stiffness apply/step, 2nd order, dt "
                         "scaled by 0.71")
    ap.add_argument("--full-tableau", action="store_true",
                    help="RK4 step kernel with the full Butcher tableau "
                         "(kernel C) instead of the lean stage algebra")
    ap.add_argument("--two-step", action="store_true",
                    help="RK4 with two steps per call of kernel J (raises "
                         "where it does not apply)")
    ap.add_argument("--ndev", type=int, default=None,
                    help="split the box into decompose3d(N) blocks, all on the "
                         "card (the sharded branch; run.ndev)")
    args = ap.parse_args(argv)
    cfg = (SimulationConfig.from_json(Path(args.config).read_text())
           if args.config else SimulationConfig())
    return cfg, dict(
        cells=args.cells, degree=args.degree, dtype=args.dtype,
        integrator=args.integrator, checkpoint_dir=args.checkpoint_dir,
        tile_x=args.tile_x, device=args.device, steps=args.steps,
        lean=not args.full_tableau, two_step=args.two_step, mesh=args.mesh,
        meshtags=args.meshtags, output=args.output, ndev=args.ndev,
    )


def main(argv=None):
    cfg, kw = parse_args(argv)
    print(json.dumps(run(cfg, **kw)))


if __name__ == "__main__":
    main()
