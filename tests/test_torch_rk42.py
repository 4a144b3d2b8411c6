"""Kernel J (two full-tableau RK4 steps per call): the port's plain version
and ``solve_step2_n`` against the JAX package's 2-step kernel in f64
(interpret mode), against two kernel-C steps, and the no-fallback rules.
The CUDA kernel is checked against the plain version in
test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from _torch_cases import max_rel, padded_pair, random_padded, torch_model
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.ops import rk42step, rk4step, wave

DT = 1e-9
TOL = 1e-12  # f64, relative to max |v| (test_padded_model.py:466-469)
GS = (1.0, 0.8, 0.55, 0.3, 0.1)  # distinct sources at the five stage times


def _assert_close(u, v, u_ref, v_ref, tol=TOL):
    u, v, u_ref, v_ref = (np.array(a.cpu() if isinstance(a, torch.Tensor) else a)
                          for a in (u, v, u_ref, v_ref))
    vmax = float(np.abs(v_ref).max())
    assert vmax > 0.0
    assert float(np.abs(u - u_ref).max()) < tol * max(vmax, 1.0)
    assert float(np.abs(v - v_ref).max()) < tol * vmax


@pytest.mark.parametrize("p,tile", [(2, 16), (3, 24), (4, 24)])
@pytest.mark.parametrize("nsteps", [12, 13])
def test_solve_step2_n_matches_jax(p, tile, nsteps):
    """JAX's own parameters (test_padded_model.py:454-469): even and odd
    counts, the odd last step through the lean step kernel in both."""
    jpm, pm = padded_pair(p=p, tile_x=tile)
    assert pm.rk42_unavailable is None and jpm._rk42_step_fn is not None
    ju, jv, _ = jpm.solve_step2_n(0.0, DT, nsteps)
    u, v, n = pm.solve_step2_n(0.0, DT, nsteps)
    assert n == nsteps
    _assert_close(u, v, ju, jv)


@pytest.mark.parametrize("p,tile", [(2, 16), (4, 24)])
def test_rk42_step_plain_matches_two_full_tableau_steps(p, tile):
    """One call of the plain version from a random state against two steps
    of kernel C's plain version (the TPU kernel's tile-by-tile form), with
    g sampled at t + {0, 1/2, 1} dt and t + {1, 3/2, 2} dt."""
    pm = PaddedLinearWave(torch_model(p=p), tile_x=tile)
    lay = pm.layout
    u0 = torch.as_tensor(random_padded(lay, 3 * p))
    v0 = 1e3 * torch.as_tensor(random_padded(lay, 3 * p + 1))
    u2, v2 = rk42step.rk42_step_plain(
        u0, v0, DT, GS, lay, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2,
        pm.src_x, pm.abc_x)

    def full(u, v, gs):
        return rk4step.rk4_step_full_plain(u, v, DT, gs, lay, pm.base.c0,
                                           pm.step_tables)

    uc, vc = full(u0, v0, (GS[0], GS[1], GS[1], GS[2]))
    uc, vc = full(uc, vc, (GS[2], GS[3], GS[3], GS[4]))
    _assert_close(u2, v2, uc, vc, tol=1e-13)
    outside = u2.clone()
    outside[lay.interior] = 0.0
    assert float(outside.abs().max()) == 0.0
    u_d, v_d = rk42step.rk42_step(
        u0, v0, DT, GS, lay, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2,
        pm.src_x, pm.abc_x)
    assert torch.equal(u_d, u2) and torch.equal(v_d, v2)


@pytest.mark.parametrize("p", [1, 3, 5, 6, 7, 8])
def test_rk42_step_plain_matches_two_steps_at_every_p(p):
    """The plain version of kernel J at the degrees the test above leaves
    out, each on the smallest tile >= its 6p halo (and at least 24): two
    full-tableau steps in one call equal two kernel-C plain steps (1e-13),
    the padding of (u2, v2) exactly zero."""
    pm = PaddedLinearWave(torch_model(p=p), tile_x=max(24, rk42step._off0(p)))
    assert pm.rk42_unavailable is None
    lay = pm.layout
    u0 = torch.as_tensor(random_padded(lay, 5 * p))
    v0 = 1e3 * torch.as_tensor(random_padded(lay, 5 * p + 1))
    u2, v2 = rk42step.rk42_step_plain(
        u0, v0, DT, GS, lay, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2,
        pm.src_x, pm.abc_x)
    uc, vc = u0, v0
    for gs in ((GS[0], GS[1], GS[1], GS[2]), (GS[2], GS[3], GS[3], GS[4])):
        uc, vc = rk4step.rk4_step_full_plain(uc, vc, DT, gs, lay, pm.base.c0,
                                             pm.step_tables)
    _assert_close(u2, v2, uc, vc, tol=1e-13)
    for x in (u2, v2):
        outside = x.clone()
        outside[lay.interior] = 0.0
        assert float(outside.abs().max()) == 0.0


@pytest.mark.parametrize("p", [2, 4])
def test_rk42_boundary_plain_is_a_full_step_and_a_stage(p):
    """The plain step boundary (the plain version of the boundary kernel)
    from step 1's stages kv0..kv2: (u1, v1) is one kernel-C plain step
    (1e-13), and kv0' is stage 0 of the next step from (u1, v1)."""
    pm = PaddedLinearWave(torch_model(p=p), tile_x=24)
    lay = pm.layout
    face = (lay, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
    u0 = torch.as_tensor(random_padded(lay, 7 * p))
    v0 = 1e3 * torch.as_tensor(random_padded(lay, 7 * p + 1))
    kv_of, stage, _ = rk42step._phases(u0, DT, *face)
    kv0 = kv_of(u0, v0, GS[0])
    kv1 = stage(1, u0, v0, kv0, None, None, GS[1])
    kv2 = stage(2, u0, v0, kv0, kv1, None, GS[1])
    u1, v1, kv0n = rk42step.rk42_boundary_plain(u0, v0, kv0, kv1, kv2, DT, GS[2], *face)
    uc, vc = rk4step.rk4_step_full_plain(u0, v0, DT, (GS[0], GS[1], GS[1], GS[2]), lay,
                                         pm.base.c0, pm.step_tables)
    _assert_close(u1, v1, uc, vc, tol=1e-13)
    assert max_rel(kv0n, kv_of(u1, v1, GS[2])) == 0.0
    for x in (u1, v1, kv0n):
        outside = x.clone()
        outside[lay.interior] = 0.0
        assert float(outside.abs().max()) == 0.0


@pytest.mark.parametrize("p", [2, 4])
def test_apply_stencil_plain_matches_flat_apply(p):
    """The plain version of csrc/stencil.cuh (J's plain phases) against
    kernel B's plain version."""
    pm = PaddedLinearWave(torch_model(p=p), tile_x=16)
    x = torch.as_tensor(random_padded(pm.layout, 9 + p))
    got = wave.apply_stencil_plain(x, pm.layout, pm.stencil)
    assert max_rel(got, wave.apply_flat_plain(x, pm.layout, pm.flat_tables)) <= TOL


@pytest.mark.parametrize("lean", [True, False])
def test_solve_step2_n_odd_tail_follows_lean(lean):
    """An odd count ends on the step kernel ``lean`` selects: the same
    state as solve_step_n of the same model to round-off."""
    pm = PaddedLinearWave(torch_model(p=2), tile_x=16, lean=lean)
    u1, v1, _ = pm.solve_step_n(0.0, DT, 7)
    u2, v2, _ = pm.solve_step2_n(0.0, DT, 7)
    _assert_close(u2, v2, u1, v1, tol=1e-13)


def test_rk42_unavailable_below_6p_halo():
    """No fallback: tile 16 < the 6p slab halo 24 at p = 4."""
    pm = PaddedLinearWave(torch_model(p=4), tile_x=16)
    assert "6p slab halo" in pm.rk42_unavailable
    with pytest.raises(ValueError, match="6p slab halo"):
        pm.solve_step2_n(0.0, DT, 2)
    with pytest.raises(ValueError, match="6p slab halo"):
        rk42step.rk42_step_plain(
            *pm.zero_state(), DT, GS, pm.layout, pm.base.c0, pm.stencil,
            pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)


def test_rk42_unavailable_without_x_faces():
    pm = PaddedLinearWave(torch_model(p=2, tags={1: (2,), 2: (3,)}), tile_x=16)
    with pytest.raises(ValueError, match="x-faces"):
        pm.solve_step2_n(0.0, DT, 2)
