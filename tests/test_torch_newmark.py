"""The port's implicit Newmark integrator (``solvers/newmark.py``) against
the JAX package's ``newmark_solve_n`` on the CPU in float64, on JAX's own
case (tests/test_solvers.py:123-151): (u, v, a) within 1e-12 relative;
agreement with RK4 to O(dt^2); stability at 10x the explicit CFL step;
the CG statistics it records."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import max_rel

from wave_fenics_tpu.core.dofmap import StructuredDofGrid as JStructuredDofGrid
from wave_fenics_tpu.core.mesh import FacetTags as JFacetTags
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.models.linear_wave import LinearWave as JLinearWave
from wave_fenics_tpu.solvers.newmark import newmark_solve_n as jnewmark
from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu_torch.models.linear_wave import LinearWave
from wave_fenics_tpu_torch.solvers.newmark import newmark_solve_n

F64 = torch.float64
# CG stops at rtol 1e-9 in both packages after the same iterations; their
# iterates differ only by association order (measured: u 2e-15, v 4e-14,
# a 5e-14 of max|ref| after 100 steps), far inside CG's own tolerance
TOL = 1e-12


def _case(tags=None):
    cells, extent = (6, 2, 2), (1.0, 0.3, 0.3)
    jmesh = jbox_mesh(cells, extent, facet_tags=JFacetTags(tags or {}))
    jm = JLinearWave(jmesh, p=3, c0=1.0, dtype=jnp.float64)
    tm = LinearWave(box_mesh(cells, extent, facet_tags=FacetTags(tags or {})), p=3,
                    c0=1.0, dtype=F64, device="cpu")
    C = JStructuredDofGrid(jmesh, 3).dof_coords_grid()
    u0 = np.sin(np.pi * C[..., 0])
    return jm, tm, u0, np.zeros_like(u0)


@pytest.mark.parametrize("tags", [None, {1: (0,), 2: (1,)}])
def test_newmark_matches_jax(tags):
    """(u, v, a) after 100 steps, closed box and with the x-face source and
    absorbing planes (the W1, W2 terms of A and of the right-hand side)."""
    jm, tm, u0, v0 = _case(tags)
    dt, n = 2e-3, 100
    ju, jv, ja = jnewmark(jm, dt, n, jnp.asarray(u0), jnp.asarray(v0), t0=1e-3)
    stats = {}
    u, v, a = newmark_solve_n(tm, dt, n, torch.as_tensor(u0), torch.as_tensor(v0),
                              t0=1e-3, stats=stats)
    for got, want in ((u, ju), (v, jv), (a, ja)):
        assert max_rel(got, np.asarray(want)) <= TOL
    its = stats["cg_iterations"]
    assert len(its) == n and all(0 < k <= 40 for k in its)
    assert stats["host_syncs"] == sum(k + (k < 40) for k in its)


def test_newmark_matches_rk4_and_is_stable():
    _, tm, u0, v0 = _case()
    u0, v0 = torch.as_tensor(u0), torch.as_tensor(v0)
    dt, n = 2e-3, 100
    u_rk, _, _ = tm.solve(0.0, n * dt, dt, u0, v0)
    u_nm, _, _ = newmark_solve_n(tm, dt, n, u0, v0)
    rel = float(torch.linalg.norm(u_nm - u_rk) / torch.linalg.norm(u_rk))
    assert rel < 5e-3, rel  # O(dt^2) phase error against O(dt^4)
    big_dt = 0.2  # 10x dt; about 4x beyond RK4's stability limit here
    u_big, _, _ = newmark_solve_n(tm, big_dt, 200, u0, v0)
    assert bool(torch.isfinite(u_big).all())
    assert float(u_big.abs().max()) < 10 * float(u0.abs().max())
    u_rk_big, _, _ = tm.solve(0.0, 200 * big_dt, big_dt, u0, v0)
    assert not bool(torch.isfinite(u_rk_big).all())  # RK4 explodes


def test_newmark_model_mass_buffer():
    _, tm, _, _ = _case()
    assert torch.equal(tm.m, torch.as_tensor(tm.ops.lumped_mass))
    assert max_rel(tm.m * tm.inv_m, torch.ones_like(tm.m)) <= 1e-15
