"""Kernels H and I (leapfrog): the port's tables, plain steps, solvers and
app against the JAX package in float64 on small models. The CUDA kernels
are checked against the plain versions in test_torch_gpu.py."""

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
from wave_fenics_tpu.models.planar3d import planar3d_case as j_planar3d_case
from wave_fenics_tpu.ops import pallas_lf2step as jlf2
from wave_fenics_tpu.ops import pallas_lfstep as jlf
from wave_fenics_tpu.ops.separable import grid_lines as j_grid_lines
from wave_fenics_tpu.ops.separable import (
    separable_stiffness_tables as j_sep_tables,
)
from wave_fenics_tpu.solvers.leapfrog import leapfrog_solve_n as j_leapfrog_solve_n
from wave_fenics_tpu_torch.apps import planar3d_app
from wave_fenics_tpu_torch.convert import state_from_numpy, tables_from_numpy
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.ops import lf2step, lfstep
from wave_fenics_tpu_torch.solvers.leapfrog import leapfrog_solve_n

F64 = torch.float64
DT = 1e-9
NSTEPS = 25
TOL = 1e-12  # f64, relative to max |v| (test_padded_model.py:415-416)
TOL2 = 1e-13  # lf2 against lf (test_padded_model.py:450-451)


def _assert_close(u, v, u_ref, v_ref, tol=TOL):
    u, v, u_ref, v_ref = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                          for a in (u, v, u_ref, v_ref))
    vmax = float(np.abs(v_ref).max())
    assert vmax > 0.0
    assert float(np.abs(u - u_ref).max()) < tol * max(vmax, 1.0)
    assert float(np.abs(v - v_ref).max()) < tol * vmax


def _jax_table_args(jpm):
    b = jpm.base
    w1, w2, src_x, abc_x = j_x_face_planes(jpm)
    A, _ = j_sep_tables(b.p, b.mesh.h, b.dtype)
    lines = j_grid_lines(b.mesh.shape, b.p, b.dtype)
    return (A, lines, -float(b.c0) ** 2, jpm._m_lines, w1, w2, src_x, abc_x)


@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_lf_and_lf2_tables_equal(p):
    """The port's lf/lf2 table builders and the model's buffers are
    bit-identical to the JAX builders' tables."""
    jpm, pm = padded_pair(p=p)
    assert pm.lf_unavailable is None and pm.lf2_unavailable is None
    args = _jax_table_args(jpm)
    for build, jbuild, registered in (
        (lfstep.build_lf_tables, jlf.build_lf_tables, pm.lf_tables),
        (lf2step.build_lf2_tables, jlf2.build_lf2_tables, pm.lf2_tables),
    ):
        want = jbuild(jpm.layout, *args, dtype=jnp.float64)
        got = build(pm.layout, *args, dtype=F64)
        assert len(got) == len(want) == len(registered)
        for g, r, w in zip(got, registered, want):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(r.numpy(), np.asarray(w))


def test_linear_wave_force_and_damping_match_jax():
    jm, tm = jax_model(), torch_model()
    u = np.random.default_rng(41).standard_normal(tm.ops.grid_shape)
    t = 0.3 * tm.period
    got = tm.force(t, torch.as_tensor(u))
    want = jm.force(jnp.asarray(t), jnp.asarray(u))
    assert max_rel(got, np.asarray(want)) <= 1e-13
    np.testing.assert_array_equal(tm.damping.numpy(), jm.damping)


def test_padded_force_and_damping_match_jax():
    jpm, pm = padded_pair(p=4)
    u = random_padded(pm.layout, 42)
    t = 0.3 * pm.base.period
    got = pm.force(t, torch.as_tensor(u))
    want = jpm.force(jnp.asarray(t), jnp.asarray(u))
    assert max_rel(got, np.asarray(want)) <= 1e-13
    np.testing.assert_array_equal(pm.damping.numpy(), np.asarray(jpm.damping))


def test_leapfrog_solver_matches_jax_on_base_model():
    """solvers/leapfrog.py on the reference-semantics model's split."""
    jm, tm = jax_model(), torch_model()
    ju, jv = j_leapfrog_solve_n(jm.force, jnp.asarray(jm.damping),
                                *jm.zero_state(), 0.0, DT, NSTEPS)
    u, v = leapfrog_solve_n(tm.force, tm.damping, *tm.zero_state(), 0.0, DT,
                            NSTEPS)
    _assert_close(u, v, ju, jv)


@pytest.mark.parametrize("p", [2, 4])
def test_solve_lf_n_matches_jax(p):
    """Port solve_lf_n (kernel H's plain version) == JAX solve_lf_n (its
    Pallas kernel in interpret mode under lax.scan) == JAX leapfrog_solve_n
    on the padded force."""
    jpm, pm = padded_pair(p=p)
    ju, jv, _ = jpm.solve_lf_n(0.0, DT, NSTEPS)
    xu, xv = j_leapfrog_solve_n(jpm.force, jpm.damping, *jpm.zero_state(), 0.0,
                                DT, NSTEPS)
    u, v, n = pm.solve_lf_n(0.0, DT, NSTEPS)
    assert n == NSTEPS
    _assert_close(u, v, ju, jv)
    _assert_close(u, v, xu, xv)
    # the port's own eager leapfrog on the padded split agrees as well
    lu, lv = leapfrog_solve_n(pm.force, pm.damping, *pm.zero_state(), 0.0, DT,
                              NSTEPS)
    _assert_close(u, v, lu, lv)


@pytest.mark.parametrize("nsteps", [24, 25])
def test_solve_lf2_n_matches_jax(nsteps):
    """Even and odd step counts (an odd last step runs through kernel H)."""
    jpm, pm = padded_pair(p=4)
    ju, jv, _ = jpm.solve_lf2_n(0.0, DT, nsteps)
    u, v, n = pm.solve_lf2_n(0.0, DT, nsteps)
    assert n == nsteps
    _assert_close(u, v, ju, jv, TOL2)
    # and the port's own lf2 == its lf (the JAX package's own check)
    lu, lv, _ = pm.solve_lf_n(0.0, DT, nsteps)
    _assert_close(u, v, lu, lv, TOL2)


@pytest.mark.parametrize("p", [2, 4])
def test_lf_and_lf2_steps_match_jax_kernels_on_random_state(p):
    """One call from a random interior state: JAX's own tables carried over
    by convert.py, through the plain versions, against the JAX kernels."""
    jpm, pm = padded_pair(p=p)
    args = _jax_table_args(jpm)
    u0 = random_padded(pm.layout, 43)
    v0 = random_padded(pm.layout, 44) * 1e3
    ut, vt = state_from_numpy(u0, v0, "cpu", F64)
    gs = (1.0, 0.6, 0.2)
    c0 = pm.base.c0

    jt = jlf.build_lf_tables(jpm.layout, *args, dtype=jnp.float64)
    step = jax.jit(jlf.make_lf_step_raw(jpm.layout, c0, dtype=jnp.float64))
    ju, jv = step(jnp.asarray(u0), jnp.asarray(v0), DT, *gs[:2],
                  *[jnp.asarray(t) for t in jt])
    conv = lfstep.LFTables(*tables_from_numpy(jt, "cpu", F64))
    u, v = lfstep.lf_step_plain(ut, vt, DT, *gs[:2], pm.layout, c0, conv)
    _assert_close(u, v, ju, jv, TOL2)

    jt = jlf2.build_lf2_tables(jpm.layout, *args, dtype=jnp.float64)
    step2 = jax.jit(jlf2.make_lf2_step_raw(jpm.layout, c0, dtype=jnp.float64))
    ju, jv = step2(jnp.asarray(u0), jnp.asarray(v0), DT, *gs,
                   *[jnp.asarray(t) for t in jt])
    conv = lf2step.LF2Tables(*tables_from_numpy(jt, "cpu", F64))
    u, v = lf2step.lf2_step_plain(ut, vt, DT, *gs, pm.layout, c0, conv)
    _assert_close(u, v, ju, jv, TOL2)


def test_lf_step_second_order_vs_rk4():
    """The leapfrog path converges to the RK4 solution at O(dt^2)
    (test_padded_model.py:419-433, on the port)."""
    _, pm = padded_pair(p=4)
    dt = 4e-9
    u_ref, _, _ = pm.solve_step_n(0.0, dt / 4, 256)
    scale = float(u_ref.abs().max())
    e1 = float((pm.solve_lf_n(0.0, dt / 2, 128)[0] - u_ref).abs().max()) / scale
    e2 = float((pm.solve_lf_n(0.0, dt / 4, 256)[0] - u_ref).abs().max()) / scale
    assert e2 < 0.02, e2
    assert 2.8 < e1 / e2 < 5.5, (e1, e2, e1 / e2)


def test_app_leapfrog_matches_jax_padded_leapfrog():
    """planar3d_app's leapfrog (dt x 0.71, kernel I's plain version) ==
    the JAX package's padded leapfrog at the same dt."""
    steps = 9
    out = planar3d_app.run(cells=(4, 2, 2), dtype="f64", device="cpu",
                           integrator="leapfrog", steps=steps)
    assert out["nsteps"] == steps
    assert "2-step leapfrog" in out["solver_path"]
    jc = j_planar3d_case(ncells=(4, 2, 2), domain_length=0.1, dtype=jnp.float64)
    assert out["dt"] == jc.dt * 0.71
    jpm = JPaddedLinearWave(jc.model, tile_x=48)
    ju, _ = j_leapfrog_solve_n(jpm.force, jpm.damping, *jpm.zero_state(),
                               jc.t0, jc.dt * 0.71, steps)
    # the app's own norm (float32, torch's reduction order) of JAX's state
    want = float(torch.linalg.norm(torch.tensor(np.asarray(ju)).float()))
    assert out["u_norm"] == pytest.approx(want, rel=1e-6)
    assert out["u_norm"] > 0.0


def test_app_leapfrog_step_counts():
    """Leapfrog scales the case's step count by 1/0.71, as the JAX app."""
    case, _ = planar3d_app.build(cells=(4, 2, 2), dtype="f64", device="cpu")
    out = planar3d_app.run(cells=(4, 2, 2), dtype="f64", device="cpu",
                           integrator="leapfrog")
    assert out["nsteps"] == int(np.ceil(case.nsteps / 0.71))


def test_lf_paths_raise_where_their_kernel_does_not_apply():
    """No fallback: lf2's 3p halo (24) exceeds tile 16 at p=8, where lf's 2p
    halo (16) fits; y-face tags put every leapfrog kernel out of reach."""
    pm = PaddedLinearWave(torch_model(p=8), tile_x=16)
    assert pm.lf_unavailable is None
    with pytest.raises(ValueError, match="3p slab halo 24"):
        pm.solve_lf2_n(0.0, DT, 2)
    u, v, _ = pm.solve_lf_n(0.0, DT, 2)
    assert float(v.abs().max()) > 0.0
    pm = PaddedLinearWave(torch_model(tags={1: (2,), 2: (3,)}), tile_x=16)
    for solve in (pm.solve_lf_n, pm.solve_lf2_n):
        with pytest.raises(ValueError, match="x-faces"):
            solve(0.0, DT, 2)


def test_app_picks_lf_at_degree_8():
    out = planar3d_app.run(cells=(4, 2, 2), degree=8, dtype="f64",
                           device="cpu", integrator="leapfrog", steps=3)
    assert "leapfrog step" in out["solver_path"]
    case, pm = planar3d_app.build(cells=(4, 2, 2), degree=8, dtype="f64",
                                  device="cpu")
    u, _, _ = pm.solve_lf_n(case.t0, case.dt * 0.71, 3)
    assert out["u_norm"] == pytest.approx(float(torch.linalg.norm(u.float())),
                                          rel=1e-6)
