"""The port's vector algebra and CG against the JAX package on the same
inputs (float64, CPU): the dense SPD system of ``test_solvers.py``, the
spectral mass, the padded BP1 mass (with and without Jacobi; the JAX side
runs its fused mass kernel in interpret mode) and a shifted stiffness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wave_fenics_tpu.benchmarks.cg_bench import _bp1_setup as j_bp1_setup
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.ops import la as jla
from wave_fenics_tpu.ops.operators import StructuredOperators as JOps
from wave_fenics_tpu.solvers.cg import cg as jcg
from wave_fenics_tpu_torch.core.mesh import box_mesh
from wave_fenics_tpu_torch.ops import la
from wave_fenics_tpu_torch.ops.mass import bp1_setup, mass_apply
from wave_fenics_tpu_torch.ops.operators import StructuredOperators
from wave_fenics_tpu_torch.solvers.cg import cg

F64 = torch.float64
CPU = torch.device("cpu")


@pytest.mark.parametrize("shape,same", [
    ((5, 4, 3), False), ((40,), False), ((7, 1, 9), False), ((5, 4, 3), True),
])
def test_inner_product_matches_jax(shape, same):
    """<a, b> over all entries as a 0-d tensor; with a = b, JAX's
    squared_norm."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal(shape) + 2.0
    b = a if same else rng.standard_normal(shape) + 2.0
    want = jla.squared_norm(jnp.asarray(a)) if same else jla.inner_product(
        jnp.asarray(a), jnp.asarray(b))
    got = la.inner_product(torch.as_tensor(a), torch.as_tensor(b))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-14, atol=0)


@pytest.mark.parametrize("p,q", [(1, None), (2, None), (4, None), (8, None), (2, 9)])
def test_bp1_setup_matches_jax(p, q):
    """The BP1 layout (tile 32 at p = 1, else 16; z_align 16) and the
    Kronecker-diagonal Jacobi map equal the JAX bench's."""
    cells = (3, 2, 2)
    jlay, _, jpre = j_bp1_setup(jbox_mesh(cells, (1.0, 0.8, 1.2)), p, jnp.float64,
                                True, q=q)
    lay, _, tpre = bp1_setup(box_mesh(cells, (1.0, 0.8, 1.2)), p, F64, CPU,
                             precond=True, q=q)
    assert (lay.shape, lay.padded_shape, lay.tile_x, lay.z_align) == (
        jlay.shape, jlay.padded_shape, jlay.tile_x, jlay.z_align)
    r = np.random.default_rng(5).standard_normal(lay.padded_shape)
    np.testing.assert_array_equal(tpre(torch.as_tensor(r)).numpy(),
                                  np.asarray(jpre(jnp.asarray(r))))
    assert bp1_setup(box_mesh(cells, (1.0, 0.8, 1.2)), p, F64, CPU)[2] is None


def _both(jmatvec, tmatvec, b, jpre=None, tpre=None, **kw):
    jx, jk, jr = jcg(jmatvec, jnp.asarray(b), precond=jpre, **kw)
    x, k, r = cg(tmatvec, torch.as_tensor(b), precond=tpre, **kw)
    return (np.asarray(jx), int(jk), float(jr)), (x.numpy(), k, float(r))


def _assert_same_solve(jres, res):
    (jx, jk, jr), (x, k, r) = jres, res
    assert k == jk
    assert np.abs(x - jx).max() <= 1e-10 * np.abs(jx).max()
    assert abs(r - jr) <= 1e-9 * jr


def test_cg_dense_spd_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((40, 40))
    A = A @ A.T + 40 * np.eye(40)
    b = rng.standard_normal(40)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    jres, res = _both(lambda v: Aj @ v, lambda v: At @ v, b, kmax=100, rtol=1e-10)
    _assert_same_solve(jres, res)
    np.testing.assert_allclose(res[0], np.linalg.solve(A, b), rtol=1e-7)
    assert 0 < res[1] < 100


@pytest.mark.parametrize("p", [2, 3])
def test_cg_spectral_mass_matches_jax(p):
    jo = JOps(jbox_mesh((3, 3, 3), (1.0, 1.0, 1.0)), p, dtype=jnp.float64)
    to = StructuredOperators(box_mesh((3, 3, 3), (1.0, 1.0, 1.0)), p, dtype=F64)
    b = np.random.default_rng(1).standard_normal(to.grid_shape)
    # a diagonal with few distinct values: CG ends at roundoff after about
    # as many iterations, so the comparison stops two iterations earlier
    jres, res = _both(jo.spectral_mass, to.spectral_mass, b, kmax=4, rtol=1e-10)
    _assert_same_solve(jres, res)


@pytest.mark.parametrize("precond,kmax", [(False, 12), (True, 8)])
def test_cg_padded_bp1_mass_matches_jax(precond, kmax):
    """CG in the padded layout on the BP1 mass: the JAX fused kernel
    (interpret) and the port's plain version, the same CG. Unpreconditioned
    BP1 is ill-conditioned, and CG amplifies the two matvecs' 1e-16
    differences once the iterates near roundoff, so both runs stop at a
    kmax before that."""
    cells, p = (2, 2, 2), 2
    jlay, japply, jpre = j_bp1_setup(jbox_mesh(cells, (1.0, 1.0, 1.0)), p,
                                     jnp.float64, precond)
    lay, tables, tpre = bp1_setup(box_mesh(cells, (1.0, 1.0, 1.0)), p, F64, CPU,
                                  precond=precond)
    assert lay.padded_shape == jlay.padded_shape
    b = np.zeros(lay.padded_shape)
    b[lay.interior] = np.random.default_rng(2).standard_normal(lay.shape)
    jres, res = _both(jax.jit(japply), lambda v: mass_apply(v, lay, tables), b,
                      jpre=jpre, tpre=tpre, kmax=kmax, rtol=1e-12)
    _assert_same_solve(jres, res)
    assert res[1] == kmax
    outside = res[0].copy()
    outside[lay.interior] = 0.0
    assert np.abs(outside).max() == 0.0


def test_cg_shifted_stiffness_matches_jax():
    """CG on M + 1e-3 K (the implicit-step shape of test_solvers.py)."""
    jo = JOps(jbox_mesh((2, 2, 2), (1.0, 1.0, 1.0)), 3, dtype=jnp.float64)
    to = StructuredOperators(box_mesh((2, 2, 2), (1.0, 1.0, 1.0)), 3, dtype=F64)
    b = np.random.default_rng(3).standard_normal(to.grid_shape)
    jres, res = _both(lambda v: jo.mass(v) - 1e-3 * jo.stiffness(v, 1.0),
                      lambda v: to.mass(v) - 1e-3 * to.stiffness(v, 1.0),
                      b, kmax=400, rtol=1e-8)
    _assert_same_solve(jres, res)


def test_cg_starts_from_x0_and_stops_at_kmax():
    """r0 = b - A x0 (one matvec at the start, also for x0 = 0), kmax caps
    the iterations, and a nonzero x0 gives JAX's iterates."""
    A = np.diag(np.arange(1.0, 21.0))
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    calls = []

    def matvec(v):
        calls.append(1)
        return At @ v

    b = np.ones(20)
    _, k, _ = cg(matvec, torch.as_tensor(b), x0=torch.zeros(20, dtype=F64),
                 kmax=3, rtol=1e-14)
    assert k == 3 and len(calls) == 4
    x0 = np.random.default_rng(4).standard_normal(20)
    jx, jk, jr = jcg(lambda v: Aj @ v, jnp.asarray(b), x0=jnp.asarray(x0),
                     kmax=5, rtol=1e-12)
    x, k, r = cg(lambda v: At @ v, torch.as_tensor(b), x0=torch.as_tensor(x0),
                 kmax=5, rtol=1e-12)
    _assert_same_solve((np.asarray(jx), int(jk), float(jr)), (x.numpy(), k, float(r)))
