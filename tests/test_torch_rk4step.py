"""Kernel A (one lean RK4 step): the port's plain step and solve against the
JAX step kernel in interpret mode, against the full-tableau oracle and
against the reference-semantics model. The CUDA kernel is checked against
the plain step in test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import padded_pair, random_padded
from wave_fenics_tpu.models.linear_wave_padded import _x_face_planes as j_x_face_planes
from wave_fenics_tpu.ops import pallas_rk4step as jstep
from wave_fenics_tpu.ops.separable import grid_lines as j_grid_lines
from wave_fenics_tpu.ops.separable import (
    separable_stiffness_tables as j_sep_tables,
)
from wave_fenics_tpu_torch.convert import state_from_numpy, tables_from_numpy
from wave_fenics_tpu_torch.ops import rk4step

F64 = torch.float64
DT = 1e-9
NSTEPS = 25
TOL = 1e-12  # f64, relative to max |v| (test_padded_model.py:250-252)
GS = (1.0, 0.7, 0.4, 0.1)  # distinct per-stage sources


def _assert_close(u, v, u_ref, v_ref):
    u, v, u_ref, v_ref = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                          for a in (u, v, u_ref, v_ref))
    vmax = float(np.abs(v_ref).max())
    assert vmax > 0.0
    assert float(np.abs(u - u_ref).max()) < TOL * max(vmax, 1.0)
    assert float(np.abs(v - v_ref).max()) < TOL * vmax


def _jax_step_tables(jpm):
    b = jpm.base
    w1, w2, src_x, abc_x = j_x_face_planes(jpm)
    A, _ = j_sep_tables(b.p, b.mesh.h, b.dtype)
    lines = j_grid_lines(b.mesh.shape, b.p, b.dtype)
    return jstep.build_step_tables(
        jpm.layout, A, lines, -float(b.c0) ** 2, jpm._m_lines,
        w1, w2, src_x, abc_x, dtype=jnp.float64,
    )


@pytest.mark.parametrize("p", [2, 4])
def test_solve_step_n_matches_jax(p):
    jpm, pm = padded_pair(p=p)
    ju, jv, _ = jpm.solve_step_n(0.0, DT, NSTEPS)
    u, v, n = pm.solve_step_n(0.0, DT, NSTEPS)
    assert n == NSTEPS
    _assert_close(u, v, ju, jv)


@pytest.mark.parametrize("p", [2, 4])
def test_lean_step_matches_jax_kernel_on_random_state(p):
    """One step from a random interior state, distinct g per stage: JAX's
    own tables through convert.py and the port's own table functions agree with
    the JAX lean kernel and with each other."""
    jpm, pm = padded_pair(p=p)
    jtabs = _jax_step_tables(jpm)
    u0 = random_padded(pm.layout, 21)
    v0 = random_padded(pm.layout, 22) * 1e3
    step = jax.jit(jstep.make_rk4_step_raw(jpm.layout, jpm.base.c0,
                                           dtype=jnp.float64, lean=True))
    ju, jv = step(jnp.asarray(u0), jnp.asarray(v0), DT, *GS,
                  *[jnp.asarray(t) for t in jtabs])
    ut, vt = state_from_numpy(u0, v0, "cpu", F64)
    conv = rk4step.StepTables(*tables_from_numpy(jtabs, "cpu", F64))
    u_c, v_c = rk4step.rk4_step_lean_plain(ut, vt, DT, GS, pm.layout, pm.base.c0, conv)
    u_o, v_o = rk4step.rk4_step_lean_plain(ut, vt, DT, GS, pm.layout, pm.base.c0,
                                           pm.step_tables)
    _assert_close(u_c, v_c, ju, jv)
    np.testing.assert_array_equal(u_c.numpy(), u_o.numpy())
    np.testing.assert_array_equal(v_c.numpy(), v_o.numpy())


@pytest.mark.parametrize("p", [2, 4])
def test_lean_step_matches_full_tableau(p):
    """The collapsed stage algebra == the full Butcher tableau (kernel C's
    plain version), with distinct g per stage and both faces present."""
    _, pm = padded_pair(p=p)
    args = (DT, GS, pm.layout, pm.base.c0, pm.step_tables)
    ul, vl = pm.zero_state()
    uf, vf = pm.zero_state()
    for _ in range(NSTEPS):
        ul, vl = rk4step.rk4_step_lean_plain(ul, vl, *args)
        uf, vf = rk4step.rk4_step_full_plain(uf, vf, *args)
    _assert_close(ul, vl, uf, vf)


def test_padded_solves_match_reference_semantics_model():
    """Both padded paths (RK4 on f1 = kernel B's plain version, and the
    step path) == the port's unpadded LinearWave.solve."""
    _, pm = padded_pair(p=4)
    u_ref, v_ref, _ = pm.base.solve(0.0, NSTEPS * DT, DT)
    u_f, v_f, _ = pm.solve(0.0, NSTEPS * DT, DT)
    _assert_close(pm.to_grid(u_f), pm.to_grid(v_f), u_ref, v_ref)
    u_s, v_s, _ = pm.solve_step_n(0.0, DT, NSTEPS)
    _assert_close(pm.to_grid(u_s), pm.to_grid(v_s), u_ref, v_ref)
