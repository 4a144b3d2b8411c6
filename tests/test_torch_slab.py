"""Kernel E (the 3D-slab stiffness/m, p > 8 or kernel='3d'): the port's
tables, plain apply and model against the JAX package in f64, and the
no-fallback rules of the 3D-slab layout. The CUDA kernel is checked against
the plain apply in test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import jax_model, max_rel, torch_model
from wave_fenics_tpu.models.linear_wave_padded import (
    PaddedLinearWave as JPaddedLinearWave,
)
from wave_fenics_tpu.ops import pallas_wave as jwave
from wave_fenics_tpu.ops.separable import grid_lines as j_grid_lines
from wave_fenics_tpu.ops.separable import (
    separable_stiffness_tables as j_sep_tables,
)
from wave_fenics_tpu.solvers.leapfrog import leapfrog_solve_n as j_leapfrog_solve_n
from wave_fenics_tpu_torch.convert import tables_from_numpy
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.ops import wave
from wave_fenics_tpu_torch.ops.separable import grid_lines, separable_stiffness_tables
from wave_fenics_tpu_torch.solvers.leapfrog import leapfrog_solve_n

F64 = torch.float64
TOL = 1e-12
DT = 1e-9
# (cells, p, tile_x): the JAX tests' high-degree box, and small 3D-slab
# layouts with a ragged last x-tile
CASES = [((2, 1, 1), 9, 16), ((2, 1, 1), 10, 16), ((3, 2, 1), 2, 16),
         ((2, 2, 1), 3, 16)]


def _random_padded(layout, seed):
    x = np.zeros(layout.padded_shape)
    x[layout.interior] = np.random.default_rng(seed).standard_normal(layout.shape)
    return x


def _pair(cells, p, tile_x):
    """(JAX layout, port layout, JAX tables inputs, port tables inputs)."""
    jm, tm = jax_model(cells, p), torch_model(cells, p)
    shape = tuple(n * p + 1 for n in cells)
    jlay = jwave.PaddedLayout(shape=shape, p=p, tile_x=tile_x)
    lay = wave.PaddedLayout(shape=shape, p=p, tile_x=tile_x)
    jargs = (j_sep_tables(p, jm.mesh.h, jnp.float64)[0],
             j_grid_lines(jm.mesh.shape, p, jnp.float64), -float(jm.c0) ** 2,
             JPaddedLinearWave(jm, tile_x=tile_x, kernel="3d")._m_lines)
    args = (separable_stiffness_tables(p, tm.mesh.h, F64)[0],
            grid_lines(tm.mesh.shape, p, F64), -float(tm.c0) ** 2,
            PaddedLinearWave(tm, tile_x=tile_x, kernel="3d")._m_lines)
    return jlay, lay, jargs, args


@pytest.mark.parametrize("cells,p,tile_x", CASES)
def test_slab_tables_equal(cells, p, tile_x):
    jlay, lay, jargs, args = _pair(cells, p, tile_x)
    assert lay.padded_shape == jlay.padded_shape
    want = jwave.build_tables(jlay, *jargs, dtype=jnp.float64, yz_matmul=False)
    got = wave.build_tables(lay, *args, dtype=F64)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("yz_matmul", [True, False])
@pytest.mark.parametrize("cells,p,tile_x", [((3, 2, 1), 2, 16), ((2, 1, 1), 9, 16),
                                            ((2, 1, 1), 10, 16), ((3, 2, 3), 4, 16)])
def test_apply_slab_plain_matches_jax(cells, p, tile_x, yz_matmul):
    """One apply from a random state against the JAX TPU kernel in interpret
    mode, in the band-matrix form the JAX model runs (yz_matmul) and in the
    tap form; the padding exactly 0."""
    jlay, lay, jargs, args = _pair(cells, p, tile_x)
    x = _random_padded(lay, 3 + p)
    japply = jwave.make_padded_stiffness(jlay, *jargs, dtype=jnp.float64,
                                         yz_matmul=yz_matmul)
    want = np.asarray(jax.jit(japply)(jnp.asarray(x)))
    tables = wave.SlabTables(*tables_from_numpy(
        wave.build_tables(lay, *args, dtype=F64), "cpu", F64))
    got = wave.apply_slab_plain(torch.as_tensor(x), lay, tables)
    assert max_rel(got, want) <= TOL
    outside = got.clone()
    outside[lay.interior] = 0.0
    assert float(outside.abs().max()) == 0.0
    assert torch.equal(wave.apply_slab(torch.as_tensor(x), lay, tables), got)


@pytest.mark.parametrize("p", [9, 10])
def test_high_degree_resolves_to_slab_layout(p):
    """p > 8 takes the 3D-slab layout (z aligned to 128, the tile as given),
    as the JAX model does; it no longer raises."""
    tm = torch_model(shape=(2, 1, 1), p=p)
    pm = PaddedLinearWave(tm, tile_x=16)
    jpm = JPaddedLinearWave(jax_model((2, 1, 1), p), tile_x=16)
    assert pm.kernel == jpm._kernel_resolved == "3d"
    assert pm.layout.padded_shape == jpm.layout.padded_shape
    assert pm.layout.z_align == 128 and pm.layout.tile_x == 16
    assert pm.stencil is None and pm.flat_tables is None
    assert pm.slab_tables is not None


def test_slab_apply_matches_flat_apply():
    """kernel='3d' at p = 4: the same operator as the flat layout's, on the
    interior."""
    tm = torch_model(p=4)
    p3 = PaddedLinearWave(tm, tile_x=16, kernel="3d")
    pf = PaddedLinearWave(tm, tile_x=16)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(p3.layout.shape))
    y3 = p3.to_grid(p3._apply(p3.from_grid(x)))
    yf = pf.to_grid(pf._apply(pf.from_grid(x)))
    assert max_rel(y3, yf) <= TOL


@pytest.mark.parametrize("cells", [(2, 1, 1), (4, 2, 2)])
def test_p9_rk4_solve_matches_jax(cells):
    """The p = 9 model's RK4 on f1 (solve_n) against JAX's PaddedLinearWave,
    which resolves to its 3D-slab kernel (interpret mode, under
    lax.scan)."""
    jpm = JPaddedLinearWave(jax_model(cells, 9), tile_x=16)
    pm = PaddedLinearWave(torch_model(cells, 9), tile_x=16)
    ju, jv = jpm.solve_n(0.0, DT, 3)
    u, v = pm.solve_n(0.0, DT, 3)
    vmax = float(np.abs(np.asarray(jv)).max())
    assert vmax > 0.0
    assert float(np.abs(u.numpy() - np.asarray(ju)).max()) <= TOL * max(vmax, 1.0)
    assert max_rel(v, np.asarray(jv)) <= TOL


def test_p9_leapfrog_on_force_matches_jax():
    """Leapfrog on ``force`` (kernel E's plain version) against the JAX
    leapfrog on its padded ``force`` (the app's "padded XLA leapfrog")."""
    jpm = JPaddedLinearWave(jax_model((4, 2, 2), 9), tile_x=16)
    pm = PaddedLinearWave(torch_model((4, 2, 2), 9), tile_x=16)
    ju, jv = jax.jit(lambda u, v: j_leapfrog_solve_n(
        jpm.force, jpm.damping, u, v, 0.0, 0.7 * DT, 4))(*jpm.zero_state())
    u, v = leapfrog_solve_n(pm.force, pm.damping, *pm.zero_state(), 0.0, 0.7 * DT, 4)
    assert max_rel(v, np.asarray(jv)) <= TOL
    assert float(np.abs(np.asarray(jv)).max()) > 0.0


@pytest.mark.parametrize("solver", ["solve_step_n", "solve_fused_n", "solve_lf_n",
                                    "solve_lf2_n", "solve_step2_n"])
def test_fused_solvers_raise_under_slab_layout(solver):
    """No fallback: every fused solver needs the flat layout and raises
    under kernel='3d' with the condition named."""
    pm = PaddedLinearWave(torch_model(p=4), tile_x=24, kernel="3d")
    with pytest.raises(ValueError, match="needs the flat layout"):
        getattr(pm, solver)(0.0, DT, 2)


def test_slab_layout_rejects_a_tile_below_p():
    with pytest.raises(ValueError, match="x-slab halo"):
        PaddedLinearWave(torch_model(shape=(2, 1, 1), p=9), tile_x=8)
