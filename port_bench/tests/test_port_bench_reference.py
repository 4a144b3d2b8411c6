"""The frozen plain references against the port's own plain versions, in
float64 on the CPU at a tiny size. The references import nothing of the
port; these tests do, to hold the two side by side."""

import math

import numpy as np
import pytest
import torch

from port_bench.reference import bp1_cg, box_wave, gll
from port_bench.harness import load_cell


def _state(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g, dtype=torch.float64) * 6e4,
            torch.randn(shape, generator=g, dtype=torch.float64) * 6e9)


def test_gll_tables_match_the_port():
    from wave_fenics_tpu_torch.core.basis import gauss_points_weights, gll_points_weights, tabulate_1d

    for p in (1, 2, 4, 8):
        x, w = gll.gll(p + 1)
        px, pw = gll_points_weights(p + 1)
        np.testing.assert_allclose(x, px, atol=1e-15)
        np.testing.assert_allclose(w, pw, atol=1e-15)
        _, D = gll.lagrange(x, x)
        np.testing.assert_allclose(D, tabulate_1d(p).D, atol=1e-8)
        xq, wq = gll.gauss(p + 2)
        gx, gw = gauss_points_weights(p + 2)
        np.testing.assert_allclose(xq, gx, atol=1e-15)
        np.testing.assert_allclose(wq, gw, atol=1e-15)


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_box_wave_matches_the_port_in_f64(integrator):
    from wave_fenics_tpu_torch.apps import planar3d_app

    cell = load_cell(f"planar3d-p4.{integrator}")
    config = {**cell.config, "cells": [4, 2, 2], "dtype": "f64"}
    case, pm = planar3d_app.build((4, 2, 2), 4, "f64", None, "cpu")
    _, solve, _ = planar3d_app.solver_path(pm, integrator)
    ref = box_wave.Reference(config, cell.traffic, "cpu")
    dt = case.dt * (0.71 if integrator == "leapfrog" else 1.0)
    assert ref.dt == pytest.approx(dt, rel=1e-15)
    # the whole solve to tf, 125 RK4 steps or 177 leapfrog steps at this size
    assert ref.steps == (case.nsteps if integrator == "rk4" else math.ceil(case.nsteps / 0.71))
    u0, v0 = _state(case.model.ops.grid_shape, 3)
    # from t0 = 0: the source's ramp starts, so the source plane is checked too
    u, v = solve(0.0, dt, ref.steps, pm.from_grid(u0), pm.from_grid(v0))
    want = ref.answer({"u": u0, "v": v0})
    got = {"u": pm.to_grid(u), "v": pm.to_grid(v)}
    errs = box_wave.compare(got, want)
    assert errs["u_err"] < 1e-12 and errs["v_err"] < 1e-12, errs


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_box_wave_steps_match_the_case(integrator):
    """dt and the step count of the full cell: 1,489 RK4 steps, 2,098 leapfrog."""
    cell = load_cell(f"planar3d-p4.{integrator}")
    dt, steps = box_wave.case_steps(cell.config, integrator)
    assert steps == {"rk4": 1489, "leapfrog": 2098}[integrator]
    assert dt == pytest.approx(2e-6 / 36 * (0.71 if integrator == "leapfrog" else 1.0), rel=1e-15)


def test_bp1_mass_and_cg_match_the_port_in_f64():
    from wave_fenics_tpu_torch.core.mesh import box_mesh
    from wave_fenics_tpu_torch.ops.mass import bp1_setup, mass_apply
    from wave_fenics_tpu_torch.solvers.cg import cg

    cell = load_cell("bp1-p4-s18.cg")
    config = {**cell.config, "cells": [4, 4, 4], "dtype": "f64"}
    ref = bp1_cg.Reference(config, cell.traffic, "cpu")
    layout, tables, _ = bp1_setup(box_mesh((4, 4, 4), (1.0, 1.0, 1.0)), 4, torch.float64,
                                  torch.device("cpu"), False, q=11)
    b = torch.randn((17, 17, 17), generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    y = layout.unpad(mass_apply(layout.pad(b), layout, tables))
    assert float((y - ref.matvec(b)).abs().max() / y.abs().max()) < 1e-13
    x, k, _ = cg(lambda z: mass_apply(z, layout, tables), layout.pad(b),
                 kmax=config["kmax"], rtol=config["rtol"])
    want = ref.answer({"b": b})
    errs = bp1_cg.compare({"x": layout.unpad(x), "iters": k}, want)
    assert errs["iters_gap"] == 0 and errs["x_err"] < 1e-10, errs
