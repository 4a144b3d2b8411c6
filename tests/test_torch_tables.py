"""Host tables of the port are bit-identical to the JAX package's tables,
and convert.py carries tables and state across exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import X_FACES, jax_model, padded_pair, random_padded, torch_model
from wave_fenics_tpu.core import basis as jbasis
from wave_fenics_tpu.models.linear_wave import (
    lumped_boundary_weights as j_lumped_boundary_weights,
)
from wave_fenics_tpu.models.linear_wave_padded import _x_face_planes as j_x_face_planes
from wave_fenics_tpu.ops import pallas_rk4step as jstep
from wave_fenics_tpu.ops import pallas_wave as jwave
from wave_fenics_tpu.ops.pallas_stiffness import banded_1d_coeffs as j_banded
from wave_fenics_tpu.ops.separable import grid_lines as j_grid_lines
from wave_fenics_tpu.ops.separable import (
    separable_stiffness_tables as j_sep_tables,
)
from wave_fenics_tpu_torch import convert
from wave_fenics_tpu_torch.core import basis
from wave_fenics_tpu_torch.models.linear_wave import lumped_boundary_weights
from wave_fenics_tpu_torch.models.linear_wave_padded import _x_face_planes
from wave_fenics_tpu_torch.ops import rk4step, wave
from wave_fenics_tpu_torch.ops.separable import grid_lines, separable_stiffness_tables
from wave_fenics_tpu_torch.ops.stiffness import banded_1d_coeffs

F64 = torch.float64
H = (0.0025, 0.0025, 0.0025 * 2 / 3)  # cells of a (4, 2, 3) box on EXTENT

# (cells, p, tile_x, z_align): test_padded_model.py:20-24 and :102-131
LAYOUTS = [
    ((4, 2, 2), 4, 16, 128),
    ((4, 2, 3), 4, 16, 16),
    ((4, 2, 3), 2, 16, 16),
    ((4, 2, 3), 3, 24, 16),
    ((4, 2, 3), 3, 24, 128),
]


def _layouts(cells, p, tile_x, z_align):
    shape = tuple(n * p + 1 for n in cells)
    return (
        jwave.PaddedLayout(shape=shape, p=p, tile_x=tile_x, z_align=z_align),
        wave.PaddedLayout(shape=shape, p=p, tile_x=tile_x, z_align=z_align),
    )


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("p", [2, 3, 4])
def test_basis_and_separable_tables_equal(p):
    _assert_all_equal(basis.gll_points_weights(p + 1), jbasis.gll_points_weights(p + 1))
    jt, tt = jbasis.tabulate_1d(p), basis.tabulate_1d(p)
    _assert_all_equal((tt.B, tt.D, tt.qwts), (jt.B, jt.D, jt.qwts))
    np.testing.assert_array_equal(
        basis.lumped_weight_line(5, p, 0.3), jbasis.lumped_weight_line(5, p, 0.3)
    )
    A, L = separable_stiffness_tables(p, H, F64)
    jA, jL = j_sep_tables(p, H, jnp.float64)
    _assert_all_equal(A + L, jA + jL)
    _assert_all_equal(grid_lines((4, 2, 3), p, F64), j_grid_lines((4, 2, 3), p, jnp.float64))
    for d in range(3):
        np.testing.assert_array_equal(
            banded_1d_coeffs(A[d], 4 * p + 1, p, scale=-2.25e6),
            j_banded(jA[d], 4 * p + 1, p, scale=-2.25e6),
        )


@pytest.mark.parametrize("cells,p,tile_x,z_align", LAYOUTS)
def test_layout_and_flat_tables_equal(cells, p, tile_x, z_align):
    jlay, lay = _layouts(cells, p, tile_x, z_align)
    assert lay.padded_shape == jlay.padded_shape
    assert lay.interior == jlay.interior
    A, _ = j_sep_tables(p, H, jnp.float64)
    lines = j_grid_lines(cells, p, jnp.float64)
    m_lines = [jbasis.lumped_weight_line(cells[d], p, H[d]) for d in range(3)]
    args = (A, lines, -2.25e6, m_lines)
    _assert_all_equal(wave.axis_cv_tables(lay, *args), jwave.axis_cv_tables(jlay, *args))
    _assert_all_equal(
        wave.build_tables_flat(lay, *args, dtype=F64),
        jwave.build_tables_flat(jlay, *args, dtype=jnp.float64),
    )
    x = random_padded(lay, 3)[lay.interior]
    np.testing.assert_array_equal(
        lay.pad(torch.as_tensor(x)).numpy(), np.asarray(jlay.pad(jnp.asarray(x)))
    )


@pytest.mark.parametrize("p", [2, 3, 4])
def test_model_and_step_tables_equal(p):
    jpm, pm = padded_pair(p=p, tile_x=24 if p == 3 else 16)
    jl = jpm.layout
    assert jl.halo is None
    assert pm.layout == wave.PaddedLayout(jl.shape, jl.p, jl.tile_x, jl.z_align)
    np.testing.assert_array_equal(
        lumped_boundary_weights(pm.base.mesh, p, (0, 3)),
        j_lumped_boundary_weights(jpm.base.mesh, p, (0, 3)),
    )
    w1, w2, src_x, abc_x = _x_face_planes(pm)
    jw1, jw2, jsrc, jabc = j_x_face_planes(jpm)
    assert (src_x, abc_x) == (jsrc, jabc)
    _assert_all_equal((w1, w2), (jw1, jw2))

    b = jpm.base
    A, _ = j_sep_tables(p, b.mesh.h, b.dtype)
    lines = j_grid_lines(b.mesh.shape, p, b.dtype)
    args = (A, lines, -float(b.c0) ** 2, jpm._m_lines, jw1, jw2, jsrc, jabc)
    want = jstep.build_step_tables(jpm.layout, *args, dtype=jnp.float64)
    _assert_all_equal(rk4step.build_step_tables(pm.layout, *args, dtype=F64), want)
    # the model registers the same tables as buffers
    _assert_all_equal([t.numpy() for t in pm.step_tables], want)
    # the CUDA stencil's y/z/line tables are the step kernel's, reshaped
    st = pm.stencil
    F = want[3].shape[1]
    np.testing.assert_array_equal(st.cvy.numpy(), want[3])
    np.testing.assert_array_equal(st.cvz.numpy(), want[4])
    np.testing.assert_array_equal(st.fx.numpy(), want[5].reshape(F))


def test_headline_layout():
    """64x32x32 cells at p=4, tile 48: 4,276,737 dofs, padded (384, 144, 144)."""
    lay = wave.PaddedLayout(shape=(257, 129, 129), p=4, tile_x=48, z_align=16)
    assert np.prod(lay.shape) == 4_276_737
    assert lay.padded_shape == (384, 144, 144)


def test_convert_roundtrip_exact():
    jpm = jwave.PaddedLayout(shape=(17, 9, 9), p=4, tile_x=16)
    u = random_padded(jpm, 4)
    v = random_padded(jpm, 5)
    ut, vt = convert.state_from_numpy(u, v, "cpu", np.float64)
    assert ut.dtype == F64 and ut.is_contiguous()
    np.testing.assert_array_equal(ut.numpy(), u)
    np.testing.assert_array_equal(vt.numpy(), v)
    tabs = convert.tables_from_numpy((u[:3], v[0]), "cpu", F64)
    np.testing.assert_array_equal(tabs[0].numpy(), u[:3])
    np.testing.assert_array_equal(tabs[1].numpy(), v[0])
    assert convert.numpy_dtype(torch.float32) == np.float32
    assert convert.torch_dtype(np.float64) is F64
    with pytest.raises(ValueError):
        convert.numpy_dtype(torch.bfloat16)


def test_models_same_ops_constants():
    jm, tm = jax_model(p=3, tags=X_FACES), torch_model(p=3)
    assert tm.ops.grid_shape == jm.ops.grid_shape
    assert tm.ops.ndofs == jm.ops.ndofs
    np.testing.assert_array_equal(tm.ops.lumped_mass, jm.ops.lumped_mass)
    np.testing.assert_array_equal(tm.inv_m.numpy(), jm.inv_m)
    np.testing.assert_array_equal(tm.W1.numpy(), jm.W1)
    np.testing.assert_array_equal(tm.W2.numpy(), jm.W2)
