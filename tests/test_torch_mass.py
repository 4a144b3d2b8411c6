"""The BP1 consistent mass (kernel G's tables and plain version) against the
JAX package on the same inputs (float64, CPU).

The JAX fused mass runs its Pallas kernel in interpret mode off the TPU by
itself (``make_mass_apply``). The CUDA kernel G (csrc/mass_tiled.cu, which
contracts z, y, x in that order, as ``mass_apply_zyx_plain`` does) is
checked against the plain version in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import max_rel
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.ops import pallas_mass as jpm
from wave_fenics_tpu.ops.operators import StructuredOperators as JOps
from wave_fenics_tpu.ops.pallas_wave import PaddedLayout as JPaddedLayout
from wave_fenics_tpu.ops.separable import mass_separable as j_mass_separable
from wave_fenics_tpu.ops.separable import separable_mass_tables as j_mass_tables
from wave_fenics_tpu_torch.convert import tables_from_numpy
from wave_fenics_tpu_torch.core.mesh import box_mesh
from wave_fenics_tpu_torch.ops import mass
from wave_fenics_tpu_torch.ops.operators import StructuredOperators
from wave_fenics_tpu_torch.ops.separable import mass_separable, separable_mass_tables

F64 = torch.float64
TOL = 1e-12  # f64, relative to max |ref|: only association order differs
EXTENT = (1.0, 0.8, 1.2)


def _layouts(cells, p, tile_x=16):
    grid = tuple(n * p + 1 for n in cells)
    return (JPaddedLayout(grid, p, tile_x=tile_x, z_align=16),
            mass.mass_layout(grid, p, tile_x))


def _random_padded(layout, seed):
    x = np.zeros(layout.padded_shape)
    x[layout.interior] = np.random.default_rng(seed).standard_normal(layout.shape)
    return x


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("q", [None, 9])
def test_mass_tables_equal(p, q):
    """separable_mass_tables, the padded coefficient vectors (``_padded_cv``)
    and, from them, build_mass_tables' CVY/CVZ and the band entries of its
    WXT: bitwise equal to the JAX builders."""
    h = box_mesh((3, 2, 2), EXTENT).h
    M1 = separable_mass_tables(p, h, np.float64, q=q)
    jM1 = j_mass_tables(p, h, np.float64, q=q)
    for a, b in zip(M1, jM1):
        np.testing.assert_array_equal(a, b)
    jlay, lay = _layouts((3, 2, 2), p, tile_x=32 if p == 1 else 16)
    assert lay.padded_shape == jlay.padded_shape
    cvx, cvy, cvz = mass.mass_tables(lay, M1, np.float64)
    for d, cv in enumerate((cvx, cvy, cvz)):
        np.testing.assert_array_equal(
            cv, jpm._padded_cv(jlay, np.asarray(jM1[d]), jlay.shape[d], d))
    WXT, CVY, CVZ = jpm.build_mass_tables(jlay, jM1, jnp.float64)
    Lx, Ly, Lz = lay.padded_shape
    np.testing.assert_array_equal(np.repeat(cvy, Lz, axis=1), CVY)
    np.testing.assert_array_equal(np.tile(cvz, (1, Ly)), CVZ)
    Tx, K = lay.tile_x, 2 * p + 1
    for t in range(1, Lx // Tx - 1):
        for o in range(Tx):
            np.testing.assert_array_equal(WXT[t, o, o + 8 - p : o + 8 - p + K],
                                          cvx[:, t * Tx + o])


@pytest.mark.parametrize("p,cells", [(1, (3, 2, 2)), (2, (3, 2, 2)), (4, (2, 2, 2))])
def test_mass_apply_plain_matches_jax_kernel(p, cells):
    """Kernel G's plain version against the JAX TPU kernel (interpret mode)
    on the same padded state; the padding of y exactly zero."""
    h = box_mesh(cells, EXTENT).h
    M1 = separable_mass_tables(p, h, np.float64)
    jlay, lay = _layouts(cells, p)
    x = _random_padded(lay, 50 + p)
    want = np.asarray(jpm.make_mass_apply(jlay, M1, jnp.float64)(jnp.asarray(x)))
    tables = mass.MassTables(*tables_from_numpy(mass.mass_tables(lay, M1, F64), "cpu", F64))
    got = mass.mass_apply(torch.as_tensor(x), lay, tables)
    assert max_rel(got, want) <= TOL
    outside = got.clone()
    outside[lay.interior] = 0.0
    assert float(outside.abs().max()) == 0.0


@pytest.mark.parametrize("p,cells", [(1, (3, 2, 2)), (2, (3, 2, 2)), (3, (2, 2, 2)),
                                     (4, (2, 2, 2)), (6, (2, 1, 1)), (8, (2, 1, 1))])
def test_mass_apply_zyx_plain_matches_jax_kernel(p, cells):
    """The plain twin of kernel G in its contraction order (z, y, x) against
    the JAX TPU kernel (x, y, z; interpret mode) on the same padded state:
    the order changes only the rounding; the padding of y exactly zero."""
    h = box_mesh(cells, EXTENT).h
    M1 = separable_mass_tables(p, h, np.float64)
    jlay, lay = _layouts(cells, p)
    x = _random_padded(lay, 70 + p)
    want = np.asarray(jpm.make_mass_apply(jlay, M1, jnp.float64)(jnp.asarray(x)))
    tables = mass.MassTables(*tables_from_numpy(mass.mass_tables(lay, M1, F64), "cpu", F64))
    got = mass.mass_apply_zyx_plain(torch.as_tensor(x), lay, tables)
    assert max_rel(got, want) <= TOL
    outside = got.clone()
    outside[lay.interior] = 0.0
    assert float(outside.abs().max()) == 0.0


@pytest.mark.parametrize("cells", [(3, 2, 2), (2, 2, 2)])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("fn", ["mass_fused", "mass_separable", "mass_gauss"])
def test_bp1_mass_matches_jax(fn, p, cells):
    mesh, jmesh = box_mesh(cells, EXTENT), jbox_mesh(cells, EXTENT)
    M1 = separable_mass_tables(p, mesh.h, np.float64)
    grid = tuple(n * p + 1 for n in cells)
    x = np.random.default_rng(60 + p).standard_normal(grid)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    if fn == "mass_fused":
        got, want = mass.mass_fused(xt, M1, p), jpm.mass_fused(xj, M1, p)
    elif fn == "mass_separable":
        got = mass_separable(xt, [torch.as_tensor(m) for m in M1], p)
        want = j_mass_separable(xj, M1, p)
    else:
        got = StructuredOperators(mesh, p, dtype=F64).mass_gauss(xt)
        want = JOps(jmesh, p, dtype=jnp.float64).mass_gauss(xj)
    assert max_rel(got, np.asarray(want)) <= TOL


def test_mass_fused_cache_is_bounded():
    M1 = separable_mass_tables(1, (1.0, 1.0, 1.0), np.float64)
    for n in range(mass._FUSED_CACHE_MAX + 3):
        mass.mass_fused(torch.zeros((n + 2, 2, 2), dtype=F64), M1, 1)
    assert len(mass._FUSED_CACHE) == mass._FUSED_CACHE_MAX


def test_mass_fused_raises_above_degree_8():
    """As the JAX package's fused mass kernel (pallas_mass.py:169-170)."""
    M1 = separable_mass_tables(9, (1.0, 1.0, 1.0), np.float64)
    with pytest.raises(ValueError, match="p <= 8"):
        mass.mass_fused(torch.zeros((10, 10, 10), dtype=F64), M1, 9)


def test_kernel_g_wrapper_refuses_cpu_tensors():
    """The kernel wrapper itself never runs the plain version: on a CPU
    tensor it raises before anything is built."""
    M1 = separable_mass_tables(2, (1.0, 1.0, 1.0), np.float64)
    lay, tables = mass.mass_operator((5, 5, 5), 2, M1, F64, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        mass.mass_apply_cuda(torch.zeros(lay.padded_shape, dtype=F64), lay, tables)
