"""How a bf16 run of the box's RK4 step, or of its leapfrog, grows, and
what makes it grow.

Four runs of the planar3d case at p = 4 (``planar3d_app.build``) from
zero over its whole solve, max|u| every ``--every`` steps:

- ``bf16``: kernel A on a bf16 state and bf16 tables (the app's
  ``--dtype bf16``; the plain twin on ``--device cpu``);
- ``f32``: the same in f32;
- ``bf16 state, f32 tables``: the plain lean step on a bf16 state with the
  f32 model's tables (each stored field still rounded to bf16);
- ``f32 state, bf16 tables``: the plain lean step on an f32 state with the
  bf16 model's tables.

With ``--integrator leapfrog`` the four runs take the app's leapfrog (dt
x 0.71, the step count over 0.71): kernel I (the plain 2-step leapfrog
for the two controls, with the other model's lf2 tables; an odd count
ends on kernel H's plain step).

With ``--general`` the four runs take the imported-mesh model
(``GeneralLinearWave``, p = 4) on the perturbed box of ``--cells`` (the
P8/P16 mesh at (64, 32, 32)), over the imported case's solve
(``planar3d.general_case``): ``bf16`` and ``f32`` on kernel K (its plain
twin on ``--device cpu``), the two controls on the plain twin with the
other model's K tables (each keeping its own m, W1, W2 and state type).
``lam0`` is then the mass-weighted mean of -c0^2 K 1 / m with each
model's K tables, K applied in float32 by the plain twin:
-c0^2 <1, K 1> / sum(m).

Beside them, ``lam0`` of each model's tables: the shift of the stencil's
zero eigenvalue (the constant mode) by the tables' rounding, to first
order the mass-weighted mean of A 1 (:func:`lam0`, A applied in float32
by the plain stencil on the model's tables, which the step, lf and lf2
tables fold bit for bit). Where it is
positive the constant mode grows as exp(sqrt(lam0) t) (u'' = lam0 u), so
``sqrt(lam0)`` predicts the rate; ``fitted_rate`` is each run's rate from
the last recorded step at least ``--fit`` steps before its end, ln(max|u|
ratio) / time.

    python -m wave_fenics_tpu_torch.apps.bf16_growth [--cells 64 32 32]
        [--steps N] [--every 100] [--fit 400] [--device cuda]
        [--integrator rk4|leapfrog] [--general]

It prints the card's name and power limit (nvidia-smi; "cpu" on a CPU
device) and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import time

import numpy as np
import torch

from ..benchmarks.general_solve import LEAPFROG_DT, perturbed_box
from ..models.general_wave import GeneralLinearWave
from ..models.planar3d import general_case
from ..ops.general import PlainK, general_apply_plain
from ..ops.lf2step import lf2_step_plain
from ..ops.lfstep import lf_step_plain
from ..ops.rk4step import rk4_step_lean_plain
from ..ops.wave import apply_slab_plain, apply_stencil_plain
from .planar3d_app import build

RUNS = ("bf16", "f32", "bf16 state, f32 tables", "f32 state, bf16 tables")


def lam0(pm, model) -> float:
    """The mass-weighted mean of A 1 on ``pm``'s layout with ``model``'s
    tables (its stencil, or its slab tables in the 3D-slab layout), A
    applied in float32 by the plain version. In s^-2; lam0 h^2 is the
    same at every cell count that is a power-of-two multiple of another
    (the tables then scale exactly)."""
    lay = pm.layout
    one = lay.pad(torch.ones(lay.shape, dtype=torch.float32, device=pm.base.device))
    if model.kernel == "3d":
        a1 = apply_slab_plain(one, lay, model.slab_tables)
    else:
        a1 = apply_stencil_plain(one, lay, model.stencil)
    a1 = lay.unpad(a1).double()
    mx, my, mz = (torch.as_tensor(np.asarray(m), dtype=torch.float64, device=a1.device)
                  for m in pm._m_lines)
    m = mx[:, None, None] * my[None, :, None] * mz[None, None, :]
    return float((m * a1).sum() / m.sum())


def general_lam0(model, tables_model) -> float:
    """-c0^2 <1, K 1> / sum(m): the mass-weighted mean of A 1 (A = -c0^2 K /
    m) with ``tables_model``'s K tables, K applied in float32 by the plain
    twin, m ``model``'s. In s^-2."""
    ops = tables_model.ops
    one = torch.ones(model.ndofs, dtype=torch.float32, device=model.device)
    k1 = general_apply_plain(one, ops.tables(ops.mode("stiffness"), model.device),
                             -float(model.c0) ** 2)
    return float(k1.double().sum() / model.m.double().sum())


def _general_run(cells, steps, every, fit, device, integrator) -> dict:
    """``run`` on the imported-mesh model (``--general``)."""
    hm, tags = perturbed_box(tuple(cells), h=0.002)
    m16 = GeneralLinearWave(hm, 4, tags, dtype=torch.bfloat16, device=device)
    m32 = GeneralLinearWave(hm, 4, tags, dtype=torch.float32, device=device)
    case = general_case(m16)
    dt, total = case.dt, case.nsteps
    if integrator == "leapfrog":  # the app's leapfrog step and count
        dt, total = dt * LEAPFROG_DT, math.ceil(total / LEAPFROG_DT)
    n = total if steps is None else min(steps, total)

    def control(state_model, tables_model):
        ctl = copy.copy(state_model)
        ctl.ops = PlainK(tables_model.ops)
        return ctl

    models = {"bf16": m16, "f32": m32, "bf16 state, f32 tables": control(m16, m32),
              "f32 state, bf16 tables": control(m32, m16)}
    rec = {"model": "general", "cells": list(cells), "degree": 4, "ndofs": m16.ndofs,
           "integrator": integrator, "dt": dt, "steps": n, "every": every,
           "device": str(m16.device), "runs": {}, "seconds": {}}
    solvers = {name: (m, lambda t0, k, u, v, m=m: m.solve_n(t0, dt, k, u, v,
                                                            integrator=integrator))
               for name, m in models.items()}
    _series(rec, solvers, n, every, dt, m16.device)
    rec["lam0"] = {"f32 tables": general_lam0(m32, m32), "bf16 tables": general_lam0(m32, m16)}
    _rates(rec, n, fit, dt)
    return rec


def _series(rec, solvers, n, every, dt, dev) -> None:
    """Each run's max|u| every ``every`` steps from zero (``rec["runs"]``)
    and its seconds."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for name in RUNS:
        pm, solve = solvers[name]
        u, v = pm.zero_state()
        done, series = 0, []
        sync()
        t0 = time.perf_counter()
        while done < n:
            k = min(every, n - done)
            u, v = solve(done * dt, k, u, v)
            done += k
            series.append((done, float(u.float().abs().max())))
        sync()
        rec["seconds"][name] = time.perf_counter() - t0
        if not all(math.isfinite(m) for _, m in series):
            raise RuntimeError(f"{name}: max|u| is not finite")
        rec["runs"][name] = series


def _rates(rec, n, fit, dt) -> None:
    """sqrt(lam0) and each run's fitted rate, from the last point at least
    ``fit`` steps before the end."""
    rec["sqrt_lam0"] = {k: math.sqrt(x) if x > 0 else None for k, x in rec["lam0"].items()}
    rec["fitted_rate"] = {}
    for name, series in rec["runs"].items():
        back = [(s, m) for s, m in series if s <= n - fit]
        rec["fitted_rate"][name] = (math.log(series[-1][1] / back[-1][1])
                                    / ((n - back[-1][0]) * dt) if back else None)


def run(cells=(64, 32, 32), steps: int | None = None, every: int = 100,
        fit: int = 400, device: str = "cuda", integrator: str = "rk4",
        general: bool = False) -> dict:
    """The four runs, ``lam0`` and the rates (the JSON dict), of the box's
    padded model or (``general``) of the imported-mesh model. The plain
    steps are references: TF32 goes off."""
    if integrator not in ("rk4", "leapfrog"):
        raise ValueError(f"integrator {integrator!r}: rk4 or leapfrog")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if general:
        return _general_run(cells, steps, every, fit, torch.device(device), integrator)
    case, p16 = build(cells=cells, dtype="bf16", device=device)
    _, p32 = build(cells=cells, dtype="f32", device=device)
    if p16.layout.padded_shape != p32.layout.padded_shape:
        raise ValueError("the bf16 and f32 models' layouts differ")
    dt, total = case.dt, case.nsteps
    if integrator == "leapfrog":  # the app's leapfrog step and count
        dt, total = dt * 0.71, math.ceil(total / 0.71)
    n = total if steps is None else min(steps, total)
    lay, c0, b = p16.layout, p16.base.c0, p16.base
    g = b.g_amplitude

    def plain(state_model, model):
        def solve(t0, k, u, v):
            for i in range(k):
                t = t0 + i * dt
                gs = [g(t + c * dt) for c in (0.0, 0.5, 0.5, 1.0)]
                u, v = rk4_step_lean_plain(u, v, dt, gs, lay, c0, model.step_tables)
            return u, v

        def solve_lf(t0, k, u, v):
            for i in range(0, k - 1, 2):
                t = t0 + i * dt
                u, v = lf2_step_plain(u, v, dt, g(t), g(t + dt), g(t + 2 * dt), lay, c0,
                                      model.lf2_tables)
            if k % 2:
                t = t0 + (k - 1) * dt
                u, v = lf_step_plain(u, v, dt, g(t), g(t + dt), lay, c0, model.lf_tables)
            return u, v
        return state_model, solve_lf if integrator == "leapfrog" else solve

    def kernel(pm):
        solve = pm.solve_lf2_n if integrator == "leapfrog" else pm.solve_step_n
        return pm, lambda t0, k, u, v: solve(t0, dt, k, u, v)[:2]

    solvers = {"bf16": kernel(p16), "f32": kernel(p32),
               "bf16 state, f32 tables": plain(p16, p32),
               "f32 state, bf16 tables": plain(p32, p16)}
    rec = {"model": "box", "cells": list(cells), "degree": b.p, "ndofs": b.ops.ndofs,
           "integrator": integrator, "dt": dt, "steps": n, "every": every,
           "device": str(p16.base.device), "runs": {}, "seconds": {}}
    _series(rec, solvers, n, every, dt, p16.base.device)
    rec["lam0"] = {"f32 tables": lam0(p32, p32), "bf16 tables": lam0(p32, p16)}
    _rates(rec, n, fit, dt)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, nargs=3, default=(64, 32, 32))
    ap.add_argument("--steps", type=int, default=None, help="cap on the case's steps")
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--fit", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--integrator", choices=("rk4", "leapfrog"), default="rk4")
    ap.add_argument("--general", action="store_true",
                    help="the imported-mesh model on the perturbed box (kernel K)")
    a = ap.parse_args(argv)
    rec = run(tuple(a.cells), a.steps, a.every, a.fit, a.device, a.integrator, a.general)
    smi = "cpu"
    if rec["device"].startswith("cuda"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0].strip()
    rec["card"] = smi
    f32 = rec["runs"]["f32"]
    for name, series in rec["runs"].items():
        print(f"{name:24s} max|u| / f32's at steps "
              + ", ".join(f"{s}: {m / m32:.3g}" for (s, m), (_, m32) in zip(series, f32))
              + f"; rate over the last {a.fit} steps {rec['fitted_rate'][name]} /s; "
              f"{rec['seconds'][name]:.1f} s")
    print(f"lam0 {rec['lam0']}, sqrt(lam0) {rec['sqrt_lam0']} /s [{smi}]")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
