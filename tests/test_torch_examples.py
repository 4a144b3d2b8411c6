"""The port's four examples of this slice (``wave_fenics_tpu_torch/examples/``
``convergence_study``, ``plane_wave_validation``, ``multichip_solve``,
``unstructured_distributed_solve``) run through ``main([..., "--device",
"cpu"])`` on the CPU, their numbers held against the JAX package's
functions on the same inputs in float64 (the JAX examples run at import
and print, so their computations are repeated here through the JAX API).
Tolerances: states 1e-12 of max|reference|; errors against the analytic
wave as stated in each test."""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_cases import max_rel

from wave_fenics_tpu.core.dofmap import StructuredDofGrid as JStructuredDofGrid
from wave_fenics_tpu.core.mesh import HexMesh as JHexMesh
from wave_fenics_tpu.models.general_wave import GeneralLinearWave as JGeneralLinearWave
from wave_fenics_tpu.models.planar3d import analytic_plane_wave as janalytic
from wave_fenics_tpu.models.planar3d import planar3d_case as jplanar3d_case
from wave_fenics_tpu.parallel.partition import decompose3d as jdecompose3d
from wave_fenics_tpu_torch.examples import (
    convergence_study,
    multichip_solve,
    plane_wave_validation,
    unstructured_distributed_solve,
)

TOL = 1e-12


def _jax_line(case):
    """(u along the x node line at tf, the analytic wave there, the steps
    taken): the JAX examples' computation (convergence_study.py:25-37,
    plane_wave_validation.py:27-34)."""
    m = case.model
    u, _, nsteps = m.solve(case.t0, case.tf, case.dt)
    x = JStructuredDofGrid(m.mesh, m.p).axis_coords(0)
    return np.asarray(u)[:, 0, 0], janalytic(x, case.tf, case), int(nsteps)


def _rel_l2(u, ue):
    return float(np.linalg.norm(u - ue) / np.linalg.norm(ue))


@pytest.mark.parametrize("p", [2, 3])
def test_convergence_study_entries_match_jax(p, capsys):
    """The table's entry at nx = 8: u on the node line within 1e-12 of the
    JAX package's, the error within 1e-8 relative of JAX's ``err_for``."""
    nx = 8
    jcase = jplanar3d_case(ncells=(nx, 1, 1), domain_length=4.5e-3, width=4.5e-3 / nx,
                           degree=p, dtype=jnp.float64)
    ju, jue, _ = _jax_line(jcase)
    u, ue = convergence_study.solve_line(nx, p, device="cpu")
    assert max_rel(u, ju) <= TOL
    np.testing.assert_array_equal(ue, jue)
    r = convergence_study.main(["--device", "cpu", "--nx", str(nx), "--degrees", str(p)])
    want = _rel_l2(ju, jue)
    assert abs(r["errors"][(p, nx)] - want) <= 1e-8 * want
    table = capsys.readouterr().out.splitlines()
    assert table[0].split() == ["p", "\\", "nx", str(nx)]
    assert table[1].split()[0] == str(p)


def test_plane_wave_validation_matches_jax():
    """(32,2,2) cells over 6 mm, f64, to tf: u on the node line within 1e-12
    of the JAX package's; the error (3e-8) below 1e-6, as both examples
    assert, and JAX's within the bound that u's 1e-12 puts on it
    (sqrt(N) 1e-12 max|u| / ||u_exact||, N nodes on the line)."""
    r = plane_wave_validation.main(["--device", "cpu"])
    jcase = jplanar3d_case(ncells=(32, 2, 2), domain_length=6.0e-3, dtype=jnp.float64)
    ju, jue, jsteps = _jax_line(jcase)
    assert r["steps"] == jsteps and r["ndofs"] == jcase.model.ops.ndofs
    assert max_rel(r["u_line"], ju) <= TOL
    want = _rel_l2(ju, jue)
    assert r["rel_err"] < 1e-6 and want < 1e-6
    bound = np.sqrt(len(ju)) * TOL * np.abs(ju).max() / np.linalg.norm(jue)
    assert abs(r["rel_err"] - want) <= bound


@pytest.mark.parametrize("n", [2, 8])
def test_multichip_solve_matches_jax_one_device(n):
    """The global v of the n-block solve (f64) against the JAX package's
    one-device solve of the same case, 10 steps."""
    r = multichip_solve.main([str(n), "--device", "cpu"])
    parts = jdecompose3d(n)
    assert r["parts"] == parts and r["steps"] == 10
    jcase = jplanar3d_case(ncells=tuple(4 * m for m in parts), domain_length=0.01,
                           dtype=jnp.float64)
    _, jv, _ = jcase.model.solve(jcase.t0, jcase.t0 + 10 * jcase.dt, jcase.dt)
    assert max_rel(r["v"], np.asarray(jv)) <= TOL
    assert r["v_max"] == pytest.approx(float(np.abs(np.asarray(jv)).max()), rel=TOL)


@pytest.mark.parametrize("n", [3, 8])
def test_unstructured_distributed_solve_matches_jax(n):
    """The n-part solve's global v against the JAX package's
    ``GeneralLinearWave.solve_n`` on the same mesh and tags (f64, 10 steps of
    1 ns), and the example's own assert (1e-12 against the port's one
    device); on the CPU its parts take the plain route."""
    r = unstructured_distributed_solve.main([str(n), "--device", "cpu"])
    hm, tags = unstructured_distributed_solve.perturbed_mesh()
    jm = JGeneralLinearWave(mesh=JHexMesh(points=hm.points, cells=hm.cells), p=4,
                            facet_tags=tags, dtype=jnp.float64)
    _, jv = jm.solve_n(0.0, 1e-9, 10)
    assert r["ndofs"] == jm.ndofs and r["steps"] == 10 and r["route"] == "plain"
    assert r["rel_err"] < 1e-12
    assert max_rel(r["v"], np.asarray(jv)) <= TOL
