"""The structured operators and kernel F's plain version against the JAX
package on the same inputs (float64, CPU).

The JAX fused stiffness passes no ``interpret=`` flag, so this file runs
its Pallas kernel in interpret mode through a patched ``pallas_call``, as
``test_pallas_stiffness.py`` does. The CUDA kernel F is checked against
the plain version in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wave_fenics_tpu.ops.pallas_stiffness as jps
from _torch_cases import max_rel
from wave_fenics_tpu.core import geometry as jgeometry
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.ops import gather_scatter as jgs
from wave_fenics_tpu.ops.operators import StructuredOperators as JOps
from wave_fenics_tpu.ops.separable import stiffness_separable as j_stiffness_separable
from wave_fenics_tpu_torch.core import geometry
from wave_fenics_tpu_torch.core.mesh import box_mesh
from wave_fenics_tpu_torch.ops import gather_scatter as gs
from wave_fenics_tpu_torch.ops import stiffness
from wave_fenics_tpu_torch.ops.operators import StructuredOperators

F64 = torch.float64
TOL = 1e-12  # f64, relative to max |ref|: only association order differs
EXTENT = (1.0, 0.8, 1.2)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's fused stiffness kernel in Pallas interpret mode."""
    orig = jps.pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(jps.pl, "pallas_call", patched)


def _pair(cells, p, coeff_cells=None):
    return (JOps(jbox_mesh(cells, EXTENT), p, dtype=jnp.float64,
                 coeff_cells=coeff_cells),
            StructuredOperators(box_mesh(cells, EXTENT), p, dtype=F64,
                                coeff_cells=coeff_cells))


def _grid(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("p,cells", [(1, (3, 2, 2)), (2, (3, 2, 2)), (3, (2, 3, 1))])
def test_gather_scatter_grid_bitwise(p, cells):
    jo, to = _pair(cells, p)
    x = _grid(to.grid_shape, p)
    xe = gs.gather_grid(torch.as_tensor(x), p)
    np.testing.assert_array_equal(xe.numpy(), np.asarray(jgs.gather_grid(jnp.asarray(x), p)))
    ye = _grid(xe.shape, p + 10)
    np.testing.assert_array_equal(
        gs.scatter_grid(torch.as_tensor(ye), p, cells).numpy(),
        np.asarray(jgs.scatter_grid(jnp.asarray(ye), p, cells)))


@pytest.mark.parametrize("p,q,rule", [(2, None, "gll"), (4, None, "gll"), (3, 7, "gauss")])
def test_structured_geometric_factors_equal(p, q, rule):
    mesh, jmesh = box_mesh((3, 2, 2), EXTENT), jbox_mesh((3, 2, 2), EXTENT)
    for got, want in zip(geometry.structured_geometric_factors(mesh, p, q, rule),
                         jgeometry.structured_geometric_factors(jmesh, p, q, rule)):
        np.testing.assert_array_equal(got, want)


OPS = ["mass", "spectral_mass", "spectral_mass_roundtrip", "stiffness",
       "stiffness_percell", "mass_gauss"]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("op", OPS)
def test_operator_matches_jax(op, p):
    jo, to = _pair((3, 2, 2), p)
    x = _grid(to.grid_shape, 20 + p)
    args = (1500.0,) if "stiffness" in op else ()
    want = np.asarray(getattr(jo, op)(jnp.asarray(x), *args))
    got = getattr(to, op)(torch.as_tensor(x), *args)
    assert max_rel(got, want) <= TOL


def test_lumped_mass_equal():
    jo, to = _pair((3, 2, 2), 4)
    np.testing.assert_array_equal(to.lumped_mass, jo.lumped_mass)


@pytest.mark.parametrize("p", [2, 4])
def test_coeff_cells_stiffness_matches_jax(p):
    """A per-cell coefficient: stiffness takes the per-cell path in both."""
    cells = (3, 2, 2)
    cc = 1.0 + np.random.default_rng(30).random(int(np.prod(cells)))
    jo, to = _pair(cells, p, coeff_cells=cc)
    x = _grid(to.grid_shape, 31)
    want = np.asarray(jo.stiffness(jnp.asarray(x), 1500.0))
    assert max_rel(to.stiffness(torch.as_tensor(x), 1500.0), want) <= TOL
    assert max_rel(to.stiffness_percell(torch.as_tensor(x), 1500.0), want) <= TOL


def test_stiffness_takes_a_0d_tensor_c0():
    _, to = _pair((3, 2, 2), 2)
    x = torch.as_tensor(_grid(to.grid_shape, 32))
    np.testing.assert_array_equal(to.stiffness(x, torch.tensor(1500.0, dtype=F64)).numpy(),
                                  to.stiffness(x, 1500.0).numpy())


def _grid_tables(to, coeff):
    return stiffness.GridStiffnessTables(*(torch.as_tensor(t) for t in
                                           stiffness.stiffness_grid_tables(
        to._sepA, to._seplines, to.grid_shape, to.p, coeff, F64)))


@pytest.mark.parametrize("p,cells", [(2, (4, 2, 3)), (4, (4, 2, 2))])
@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_stiffness_grid_plain_matches_jax_fused(interpret, variant, p, cells):
    """Kernel F's plain version against the JAX TPU kernel (both variants)
    and the JAX separable stiffness; p=4 on 4 cells is the ragged Nx = 17
    that the JAX tests run with x-tiles of 4 and 8."""
    jo, to = _pair(cells, p)
    coeff = -(1500.0**2)
    x = _grid(to.grid_shape, 40 + p)
    got = stiffness.stiffness_grid_plain(torch.as_tensor(x), _grid_tables(to, coeff), p)
    fused = np.asarray(jps.stiffness_fused(jnp.asarray(x), jo._sepA, jo._seplines, p,
                                           coeff, variant=variant))
    sep = np.asarray(j_stiffness_separable(jnp.asarray(x), jo._sepA, jo._seplines,
                                           p, coeff))
    assert got.shape == x.shape
    assert max_rel(got, fused) <= TOL
    assert max_rel(got, sep) <= TOL


@pytest.mark.parametrize("p", [2, 4])
def test_stiffness_grid_tables_equal_banded_coeffs(p):
    """The expanded coefficient vectors are the JAX package's banded 1D
    coefficients with the face corrections at 0 and N - 1 (f64, bitwise)."""
    jo, to = _pair((4, 2, 3), p)
    coeff = -(1500.0**2)
    tabs = stiffness.stiffness_grid_tables(to._sepA, to._seplines, to.grid_shape,
                                           p, coeff, F64)
    for d in range(3):
        np.testing.assert_array_equal(
            tabs[d], jps.banded_1d_coeffs(jo._sepA[d], to.grid_shape[d], p, scale=coeff))
        np.testing.assert_array_equal(tabs[3 + d], jo._seplines[d])


@pytest.mark.parametrize("op", ["stiffness", "mass_gauss", "stiffness_grid"])
def test_non_cpu_tensors_do_not_take_the_plain_path(op):
    """Dispatch by device: a tensor neither on the CPU nor on a card raises."""
    _, to = _pair((2, 2, 2), 2)
    meta = torch.empty(to.grid_shape, dtype=F64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        if op == "stiffness_grid":
            stiffness.stiffness_grid(meta, _grid_tables(to, -1.0), 2)
        else:
            getattr(to, op)(meta)


def test_kernel_f_wrapper_refuses_cpu_tensors():
    """The kernel wrapper itself never runs the plain version: on a CPU
    tensor it raises before anything is built."""
    _, to = _pair((2, 2, 2), 2)
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        stiffness.stiffness_grid_cuda(torch.zeros(to.grid_shape, dtype=F64),
                                      _grid_tables(to, -1.0), 2)
