"""Kernels C (full-tableau RK4 step) and D (fused RK4 stage): the port's
plain versions and solvers against the JAX package in float64 on small
models, and the RK4 app paths that run them. The CUDA kernels are checked
against the plain versions in test_torch_gpu.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import jax_model, max_rel, padded_pair, random_padded, torch_model
from wave_fenics_tpu.models.linear_wave_padded import (
    PaddedLinearWave as JPaddedLinearWave,
)
from wave_fenics_tpu.models.linear_wave_padded import _x_face_planes as j_x_face_planes
from wave_fenics_tpu.ops import pallas_rk4step as jstep
from wave_fenics_tpu.ops import pallas_wave as jwave
from wave_fenics_tpu.ops.separable import grid_lines as j_grid_lines
from wave_fenics_tpu.ops.separable import (
    separable_stiffness_tables as j_sep_tables,
)
from wave_fenics_tpu_torch.apps import planar3d_app, profile_step
from wave_fenics_tpu_torch.convert import state_from_numpy, tables_from_numpy
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.ops import rk4step, wave

F64 = torch.float64
DT = 1e-9
NSTEPS = 25
TOL = 1e-12  # f64, relative to max |v| (test_padded_model.py:250-252)
TOL_FULL = 1e-13  # full tableau against lean (test_padded_model.py:289-290)
GS = (1.0, 0.7, 0.4, 0.1)  # distinct per-stage sources


def _assert_close(u, v, u_ref, v_ref, tol=TOL):
    u, v, u_ref, v_ref = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                          for a in (u, v, u_ref, v_ref))
    vmax = float(np.abs(v_ref).max())
    assert vmax > 0.0
    assert float(np.abs(u - u_ref).max()) < tol * max(vmax, 1.0)
    assert float(np.abs(v - v_ref).max()) < tol * vmax


@pytest.mark.parametrize("p", [2, 4])
def test_solve_fused_n_matches_jax(p):
    """Port solve_fused_n (kernel D's plain version) == JAX solve_fused_n
    (its Pallas stage kernel in interpret mode under lax.scan)."""
    jpm, pm = padded_pair(p=p)
    ju, jv, _ = jpm.solve_fused_n(0.0, DT, NSTEPS)
    u, v, n = pm.solve_fused_n(0.0, DT, NSTEPS)
    assert n == NSTEPS
    _assert_close(u, v, ju, jv)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_rk_stage_matches_jax_kernel_on_random_state(p):
    """One stage from random inputs with nonzero ca, cb and g: all four
    outputs of the plain version against the JAX stage kernel."""
    jpm, pm = padded_pair(p=p)
    b = jpm.base
    w1, w2, src_x, abc_x = j_x_face_planes(jpm)
    A, _ = j_sep_tables(b.p, b.mesh.h, b.dtype)
    lines = j_grid_lines(b.mesh.shape, b.p, b.dtype)
    tables = jwave.build_tables_flat(jpm.layout, A, lines, -float(b.c0) ** 2,
                                     inv_m_lines=jpm._m_lines, dtype=jnp.float64)
    stage = jax.jit(jwave.make_rk_stage(jpm.layout, tables, w1, w2, src_x,
                                        abc_x, b.c0, dtype=jnp.float64))
    ins = [random_padded(pm.layout, 50 + i) * s
           for i, s in enumerate((1.0, 1e3, 1e3, 1e9, 1.0, 1e3))]
    ca, cb, g = 0.5 * DT, DT / 3.0, 0.7
    want = stage(*[jnp.asarray(x) for x in ins], ca, cb, g)
    flat = wave.FlatTables(*tables_from_numpy(tables, "cpu", F64))
    got = wave.rk_stage_plain(
        *[torch.as_tensor(x) for x in ins], ca, cb, g, pm.layout, pm.base.c0,
        flat, pm.face_w1, pm.face_w2, src_x, abc_x)
    for gt, w in zip(got, want):
        assert max_rel(gt, np.asarray(w)) <= TOL_FULL
    # the padding: kv' = 0, va' = va, vn and ua' zero (zero-padded inputs)
    outside = torch.ones(pm.layout.padded_shape, dtype=torch.bool)
    outside[pm.layout.interior] = False
    assert float(got[1][outside].abs().max()) == 0.0
    assert float(got[0][outside].abs().max()) == 0.0


@pytest.mark.parametrize("p", [2, 4])
def test_full_tableau_step_matches_jax(p, monkeypatch):
    """WAVE_FENICS_STEP_LEAN=0 routes the JAX step path through its
    full-tableau kernel; the port selects kernel C's plain version with
    lean=False (no environment variable)."""
    monkeypatch.setenv("WAVE_FENICS_STEP_LEAN", "0")
    jpm = JPaddedLinearWave(jax_model(p=p), tile_x=16)
    pm = PaddedLinearWave(torch_model(p=p), tile_x=16, lean=False)
    ju, jv, _ = jpm.solve_step_n(0.0, DT, NSTEPS)
    u, v, n = pm.solve_step_n(0.0, DT, NSTEPS)
    assert n == NSTEPS
    _assert_close(u, v, ju, jv, TOL_FULL)


def test_full_tableau_step_matches_jax_kernel_on_random_state():
    jpm, pm = padded_pair(p=4)
    b = jpm.base
    w1, w2, src_x, abc_x = j_x_face_planes(jpm)
    A, _ = j_sep_tables(b.p, b.mesh.h, b.dtype)
    lines = j_grid_lines(b.mesh.shape, b.p, b.dtype)
    jtabs = jstep.build_step_tables(jpm.layout, A, lines, -float(b.c0) ** 2,
                                    jpm._m_lines, w1, w2, src_x, abc_x,
                                    dtype=jnp.float64)
    u0 = random_padded(pm.layout, 61)
    v0 = random_padded(pm.layout, 62) * 1e3
    step = jax.jit(jstep.make_rk4_step_raw(jpm.layout, b.c0, dtype=jnp.float64,
                                           lean=False))
    ju, jv = step(jnp.asarray(u0), jnp.asarray(v0), DT, *GS,
                  *[jnp.asarray(t) for t in jtabs])
    ut, vt = state_from_numpy(u0, v0, "cpu", F64)
    conv = rk4step.StepTables(*tables_from_numpy(jtabs, "cpu", F64))
    u, v = rk4step.rk4_step_full_plain(ut, vt, DT, GS, pm.layout, pm.base.c0, conv)
    _assert_close(u, v, ju, jv, TOL_FULL)


@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_fused_matches_step_path(p):
    """The stage path and the step path solve the same RK4 (the JAX
    package's test_fused_step_other_degrees, on the port)."""
    _, pm = padded_pair(p=p)
    u1, v1, _ = pm.solve_fused_n(0.0, DT, 10)
    u2, v2, _ = pm.solve_step_n(0.0, DT, 10)
    _assert_close(u2, v2, u1, v1)


def test_fused_p8_matches_reference_semantics_model():
    """At p=8 (17 taps per axis) the step kernel does not apply at tile 16;
    the stage path agrees with the unpadded reference-semantics model."""
    pm = PaddedLinearWave(torch_model(p=8), tile_x=16)
    assert pm.step_unavailable is not None and pm.stage_unavailable is None
    u_ref, v_ref, _ = pm.base.solve(0.0, 5 * DT, DT)
    u, v, _ = pm.solve_fused_n(0.0, DT, 5)
    _assert_close(pm.to_grid(u), pm.to_grid(v), u_ref, v_ref)


def test_fused_raises_without_x_faces():
    pm = PaddedLinearWave(torch_model(tags={1: (2,), 2: (3,)}), tile_x=16)
    with pytest.raises(ValueError, match="stage kernel unavailable.*x-faces"):
        pm.solve_fused_n(0.0, DT, 1)


@pytest.mark.parametrize("kw,path,solve", [
    (dict(degree=8), "fused RK4 stage", "solve_fused_n"),
    (dict(lean=False), "full-tableau RK4 step", "solve_step_n"),
])
def test_app_rk4_paths(kw, path, solve):
    """The RK4 app picks the stage path at p=8 (tile 16 < the 3p halo) and
    the full-tableau step with lean=False, and runs it."""
    out = planar3d_app.run(cells=(4, 2, 2), dtype="f64", device="cpu", steps=3,
                           **kw)
    assert path in out["solver_path"]
    case, pm = planar3d_app.build(cells=(4, 2, 2), dtype="f64", device="cpu", **kw)
    u, _, _ = getattr(pm, solve)(case.t0, case.dt, 3)
    assert out["u_norm"] == pytest.approx(float(torch.linalg.norm(u.float())),
                                          rel=1e-6)


def test_app_f1_path_without_x_faces():
    """Where no kernel path applies, the RK4 app runs RK4 on f1."""
    _, pm = padded_pair(p=2)
    pm_y = PaddedLinearWave(torch_model(p=2, tags={1: (2,), 2: (3,)}), tile_x=16)
    name, solve, warm = planar3d_app.solver_path(pm_y)
    assert "RK4 on f1" in name and warm == 1
    u, v = solve(0.0, DT, 2)
    ur, vr = pm_y.solve_n(0.0, DT, 2)
    np.testing.assert_array_equal(u.numpy(), ur.numpy())
    name, _, _ = planar3d_app.solver_path(pm_y, "leapfrog")
    assert "leapfrog on force" in name
    with pytest.raises(ValueError, match="integrator"):
        planar3d_app.solver_path(pm, "euler")


_J = {f"rk4 stage J={j}": 5 for j in range(4)}


@pytest.mark.parametrize("kw,integrator,path,want", [
    (dict(), "rk4", "lean RK4 step", _J),
    (dict(lean=False), "rk4", "full-tableau RK4 step", _J),
    (dict(degree=8), "rk4", "fused RK4 stage", {"rk stage (D)": 20}),
    (dict(), "leapfrog", "2-step leapfrog",
     {"lf OPEN": 3, "lf MID": 2, "lf CLOSE": 3}),
    (dict(degree=8), "leapfrog", "leapfrog step", {"lf OPEN": 5, "lf CLOSE": 5}),
    (dict(y_faces=True), "rk4", "RK4 on f1", {"apply_flat (B)": 20}),
    (dict(y_faces=True), "leapfrog", "leapfrog on force", {"apply_flat (B)": 6}),
    (dict(two_step=True), "rk4", "2-step RK4",
     {"rk4 stage J=0": 3, "rk4 stage J=1": 5, "rk4 stage J=2": 5, "rk4 stage J=3": 3,
      "rk42 boundary (J)": 2}),
    (dict(degree=9, cells=(2, 1, 1)), "rk4", "RK4 on f1", {"apply_slab (E)": 20}),
    (dict(degree=9, cells=(2, 1, 1)), "leapfrog", "leapfrog on force",
     {"apply_slab (E)": 6}),
])
def test_profile_expected_launches_follow_the_app_path(kw, integrator, path, want):
    """profile_step's expected launches per kernel (5 steps) are those of the
    path the app picks for the same model."""
    kw = dict(kw)
    two_step = kw.pop("two_step", False)
    if kw.pop("y_faces", False):
        pm = PaddedLinearWave(torch_model(p=2, tags={1: (2,), 2: (3,)}), tile_x=16)
    else:
        kw.setdefault("cells", (4, 2, 2))
        _, pm = planar3d_app.build(dtype="f64", device="cpu", **kw)
    assert path in planar3d_app.solver_path(pm, integrator, two_step)[0]
    assert profile_step.expected_launches(pm, integrator, 5, two_step) == want


def test_app_cli_full_tableau(capsys):
    planar3d_app.main(["--cells", "4", "2", "2", "--dtype", "f64", "--device",
                       "cpu", "--steps", "2", "--full-tableau"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "full-tableau" in out["solver_path"] and out["nsteps"] == 2
