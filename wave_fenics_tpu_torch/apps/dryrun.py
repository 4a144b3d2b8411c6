"""Every distributed path against one device, in one call.

The counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``
(:24-200), at its sizes and tolerances: ``decompose3d(n)`` blocks, 2 cells
a block on each axis of the planar3d box (0.01 m, p = 4), 3 steps, tile 4,
relative tolerance 1e-4. Every block and every part lives on the one
device through ``halo.LocalExchange`` (the sharded classes' default), so
on a card this checks the distributed logic and its kernels, not scaling.
The checks, in the JAX order:

1. ``ShardedPaddedWave.solve_n`` (per-stage halo-add; kernel B per block)
   against ``solve_step_n`` (kernel A on the 3p value halos), and both
   against ``case.model.solve`` on one device (kernel F);
2. ``ShardedGeneralWave`` on the box's hex mesh with its x-face tags
   (kernel K per part) against ``GeneralLinearWave.solve_n``, then the other
   interface-assembly mode (all-gather or pairwise rounds) against the first;
3. the general leapfrog, sharded against one device;
4. the structured leapfrog: ``solve_lf_n`` (kernel H) and ``solve_lf2_n``
   (kernel I) against ``PaddedLinearWave.solve_lf_n`` on one device;
5. the 2-step RK4 (``solve_step2_n``, kernel J, 4 steps) against
   ``PaddedLinearWave.solve_step_n`` (kernel A, on a tile of at least 3p,
   which the step kernel needs; at tile 4 the JAX model falls back to its
   stage path), unless ``step2_unavailable`` names why
   the path does not apply at these shapes (then the note records that
   reason and the check is skipped; any error the path raises propagates);
6. distributed CG (``ShardedGeneralWave.cg_solve``, kmax 50, rtol 1e-5) against
   ``solvers.cg.cg`` on one device from the same b (``default_rng(0)``): the
   same iteration count, and solutions that agree.

A check that fails raises. The JAX dry run's ``except ValueError`` around
step 5 (:161) is not copied: it would also swallow a fault of the path.

Run: python -m wave_fenics_tpu_torch.apps.dryrun [n] [--device cuda|cpu]
         [--dtype f32|f64] [--cells-per-block K]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..convert import numpy_dtype
from ..core.mesh import HEX_FACES
from ..models.general_wave import GeneralLinearWave
from ..models.linear_wave_padded import PaddedLinearWave
from ..models.planar3d import planar3d_case
from ..parallel.partition import decompose3d
from ..parallel.sharded_general import ShardedGeneralWave
from ..parallel.sharded_padded import ShardedPaddedWave
from ..solvers.cg import cg

__all__ = ["dryrun_multichip", "main"]

RTOL = 1e-4
#: RK4 steps of each solve (2-step RK4: 4; leapfrog: twice as many at dt / 2)
NSTEPS = 3


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _agree(checks: dict, name: str, got, want, rtol: float = RTOL,
           atol_scale: float = 1e-6) -> None:
    """``np.testing.assert_allclose(got, want, rtol, atol_scale max|want|)``
    (the JAX dry run's test), the largest error over max|want| recorded
    under ``name``."""
    got, want = _host(got), _host(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale,
                               err_msg=f"dry run check {name!r}")
    checks[name] = float(np.abs(got - want).max()) / scale


def _x_face_quads(hm, x0: float) -> np.ndarray:
    """The faces of ``hm`` on the plane x = x0, cell by cell, in the JAX dry
    run's vertex order."""
    on = np.abs(hm.points[:, 0] - x0) < 1e-12
    faces = hm.cells[:, HEX_FACES].reshape(-1, 4)
    return faces[on[faces].all(axis=1)]


def dryrun_multichip(n_blocks: int = 8, device: str | torch.device = "cuda",
                     dtype: torch.dtype = torch.float32, cells_per_block: int = 2) -> dict:
    """Run the checks on ``decompose3d(n_blocks)`` blocks; return what they
    found: ``parts``, ``cells``, each path's |v|max (``v_max``), each check's
    largest error over max|reference| (``checks``, in order), the exchange
    modes, the 2-step RK4 note and ``step2_unavailable`` (the guard's reason,
    or None), the CG iteration counts, the one-device state (``one_device_v``,
    the global grid) and the summary line it prints."""
    dev = torch.device(device)
    parts = decompose3d(n_blocks)
    ncells = tuple(cells_per_block * m for m in parts)
    nsteps = NSTEPS
    case = planar3d_case(ncells=ncells, domain_length=0.01, dtype=dtype, device=dev)
    md, dt = case.model, case.dt
    checks: dict[str, float] = {}
    vmax: dict[str, float] = {}

    # 1. the per-stage path against the value-halo step path, both against one device
    sw = ShardedPaddedWave(md, parts, tile_x=4)
    u, v, _ = sw.solve_n(0.0, dt, nsteps)
    us, vs, _ = sw.solve_step_n(0.0, dt, nsteps)
    ug, vg = sw.to_global(u), sw.to_global(v)
    ugs, vgs = sw.to_global_step(us), sw.to_global_step(vs)
    vmax["stage"], vmax["step"] = float(np.abs(vg).max()), float(np.abs(vgs).max())
    if not (vmax["stage"] > 0.0 and vmax["step"] > 0.0):
        raise AssertionError(f"the sharded steps left v zero: {vmax}")
    _agree(checks, "step == stage (v)", vgs, vg)
    _agree(checks, "step == stage (u)", ugs, ug)
    _, v1, _ = md.solve(0.0, nsteps * dt, dt)
    v1 = _host(v1)
    _agree(checks, "stage == one device (v)", vg, v1)

    # 2. the imported-mesh path on the box's hex mesh, both assembly modes
    hm = md.mesh.to_hex_mesh()
    L = md.mesh.origin[0] + md.mesh.h[0] * ncells[0]
    gm = GeneralLinearWave(hm, md.p, {1: _x_face_quads(hm, 0.0), 2: _x_face_quads(hm, L)},
                           dtype=dtype, device=dev)
    sg = ShardedGeneralWave(gm, n_blocks)
    _, vsg, _ = sg.solve_n(0.0, dt, nsteps)
    _, v1g = gm.solve_n(0.0, dt, nsteps)
    vgl = sg.to_global(vsg)
    vmax["general"] = float(np.abs(vgl).max())
    if not vmax["general"] > 0.0:
        raise AssertionError("the sharded general steps left v zero")
    _agree(checks, "general == one device (v)", vgl, v1g)
    other = "allgather" if sg.exchange_mode == "ppermute" else "ppermute"
    sg2 = ShardedGeneralWave(gm, n_blocks, exchange=other)
    _, vsg2, _ = sg2.solve_n(0.0, dt, nsteps)
    _agree(checks, f"{other} == {sg.exchange_mode} (v)", sg2.to_global(vsg2), vgl,
           rtol=1e-5, atol_scale=1e-7)

    # 3. the general leapfrog
    _, vlf, _ = sg.solve_n(0.0, 0.5 * dt, 2 * nsteps, integrator="leapfrog")
    _, vlf1 = gm.solve_n(0.0, 0.5 * dt, 2 * nsteps, integrator="leapfrog")
    _agree(checks, "general leapfrog == one device (v)", sg.to_global(vlf), vlf1)

    # 4. the structured leapfrog, one and two steps a kernel call
    pml = PaddedLinearWave(md, tile_x=4)
    _, vlfp, _ = pml.solve_lf_n(0.0, 0.5 * dt, 2 * nsteps)
    vlfp = _host(pml.to_grid(vlfp))
    _, vlfs, _ = sw.solve_lf_n(0.0, 0.5 * dt, 2 * nsteps)
    _agree(checks, "lf == one device (v)", sw.to_global_lf(vlfs), vlfp)
    _, vlf2, _ = sw.solve_lf2_n(0.0, 0.5 * dt, 2 * nsteps)
    _agree(checks, "lf2 == one device (v)", sw.to_global_lf2(vlf2), vlfp)

    # 5. the 2-step RK4, where its guard lets it run
    why = sw.step2_unavailable
    if why is None:
        # one device's step kernel needs a tile of at least its 3p halo (the
        # JAX model falls back to its stage path at tile 4; the port's raises)
        pstep = PaddedLinearWave(md, tile_x=max(4, 3 * md.p))
        _, v22, _ = sw.solve_step2_n(0.0, dt, 4)
        _, v22p, _ = pstep.solve_step_n(0.0, dt, 4)
        _agree(checks, "step2 == one device (v)", sw.to_global_step2(v22),
               pstep.to_grid(v22p))
        rk42_note = "sharded 2-step RK4 kernel == single-device verified"
    else:
        rk42_note = f"sharded 2-step RK4 skipped (its guard at {parts}: {why})"

    # 6. distributed CG at iteration parity with one device
    bg = np.random.default_rng(0).standard_normal(gm.ndofs).astype(numpy_dtype(dtype))
    h0 = float(md.mesh.h[0])
    tau = float(np.asarray((0.25 * h0 / (gm.c0 * gm.p * gm.p)) ** 2, numpy_dtype(dtype)))
    xd, iters, _ = sg.cg_solve(sg.from_global(bg), tau, kmax=50, rtol=1e-5)
    m1 = gm.m.to(dtype)
    x1, k1, _ = cg(lambda z: m1 * z - tau * gm.ops.stiffness(z, gm.c0),
                   torch.as_tensor(bg, device=dev), kmax=50, rtol=1e-5,
                   precond=lambda r: r / m1)
    if iters != k1:
        raise AssertionError(f"distributed CG took {iters} iterations, one device {k1}")
    _agree(checks, "distributed CG == one device (x)", sg.to_global(xd), x1,
           atol_scale=1e-5)

    summary = (
        f"dryrun_multichip ok: mesh={parts}, cells={ncells}, "
        f"{nsteps}-step |v|_max={vmax['stage']:.3e}, "
        f"step-kernel |v|_max={vmax['step']:.3e}, "
        f"stage==step==single-device verified over {nsteps} steps; "
        f"unstructured RCB path |v|_max={vmax['general']:.3e} "
        f"== single-device verified; exchange modes "
        f"({sg.exchange_mode} == {other}) verified; "
        f"sharded leapfrog (1-step and 2-step kernels) == "
        f"single-device verified; {rk42_note}; distributed CG iters "
        f"{iters} == single-device {k1} (solutions agree)")
    print(summary)
    return {"parts": parts, "cells": ncells, "nsteps": nsteps, "device": str(dev),
            "dtype": str(dtype).replace("torch.", ""), "v_max": vmax, "checks": checks,
            "exchange_modes": (sg.exchange_mode, other), "rk42_note": rk42_note,
            "step2_unavailable": why, "cg_tau": tau, "cg_iters": iters,
            "cg_iters_one_device": k1,
            "one_device_v": v1, "summary": summary}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8, help="blocks (default 8)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--cells-per-block", type=int, default=2)
    args = ap.parse_args(argv)
    dtype = {"f32": torch.float32, "f64": torch.float64}[args.dtype]
    return dryrun_multichip(args.n, device=args.device, dtype=dtype,
                            cells_per_block=args.cells_per_block)


if __name__ == "__main__":
    main()
