"""Three small functions of the port against the JAX package's, on the CPU:
``core/basis.py::hex_basix_to_lex_permutation`` (and its alias
``tensor_product_permutation``), ``core/mesh.py::StructuredBoxMesh.
cell_midpoints`` and ``utils/timing.py::Timer.table``. Tables and
coordinates exactly; the timer table in the JAX package's column format."""

import numpy as np
import pytest
import torch

from wave_fenics_tpu.core.basis import hex_basix_to_lex_permutation as jperm
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.utils.timing import Timer as JTimer
from wave_fenics_tpu_torch.core.basis import (
    hex_basix_to_lex_permutation,
    tensor_product_permutation,
)
from wave_fenics_tpu_torch.core.mesh import box_mesh
from wave_fenics_tpu_torch.utils.timing import Timer


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_basix_permutation_matches_jax(p):
    perm = hex_basix_to_lex_permutation(p)
    assert perm.dtype == np.int32
    np.testing.assert_array_equal(perm, jperm(p))
    np.testing.assert_array_equal(np.sort(perm), np.arange((p + 1) ** 3))
    assert tensor_product_permutation(p) is perm


def test_basix_permutation_places_vertices_and_interior():
    """The 8 vertices come first at the cube's corners (x fastest), the
    interior nodes last in lexicographic order."""
    p, n = 3, 4
    perm = hex_basix_to_lex_permutation(p)
    corners = [i * p + n * j * p + n * n * k * p
               for k in (0, 1) for j in (0, 1) for i in (0, 1)]
    np.testing.assert_array_equal(perm[corners], np.arange(8))
    interior = [i + n * j + n * n * k for k in (1, 2) for j in (1, 2) for i in (1, 2)]
    np.testing.assert_array_equal(perm[interior], np.arange(n**3 - 8, n**3))


@pytest.mark.parametrize("shape,extent,origin", [
    ((3, 2, 5), (0.012, 0.005, 0.0075), (-0.002, 0.001, 0.0005)),
    ((4, 1, 1), (1.0, 0.3, 0.2), (0.5, -0.25, 3.0)),
    ((1, 6, 2), (2e-3, 9e-3, 1e-3), (0.0, 0.0, 0.0)),
])
def test_cell_midpoints_match_jax(shape, extent, origin):
    got = box_mesh(shape, extent, origin).cell_midpoints()
    want = jbox_mesh(shape, extent, origin).cell_midpoints()
    assert got.shape == (int(np.prod(shape)), 3)
    np.testing.assert_array_equal(got, want)
    # each midpoint is its cell's vertex mean, cells in to_hex_mesh's order
    hm = box_mesh(shape, extent, origin).to_hex_mesh()
    np.testing.assert_allclose(got, hm.cell_coords().mean(axis=1), rtol=0, atol=1e-15)


def test_timer_table_matches_jax_format():
    """The same timers in both packages print the same table."""
    t, jt = Timer("cpu"), JTimer()
    for name, n, total in (("solve", 3, 1.25), ("setup", 1, 0.0321), ("output", 2, 4e-4)):
        t._acc[name], t._n[name] = total, n
        jt._acc[name], jt._n[name] = total, n
    assert t.table() == jt.table()
    lines = t.table().splitlines()
    assert lines[0] == f"{'timer':<40} {'calls':>6} {'total s':>10} {'mean ms':>10}"
    assert [ln.split()[0] for ln in lines[1:]] == ["output", "setup", "solve"]


def test_timer_table_one_line_a_timer():
    t = Timer("cpu")
    for _ in range(2):
        with t("matvec"):
            torch.ones(8).sum()
    with t("dot"):
        pass
    lines = t.table().splitlines()
    assert len(lines) == 3
    name, calls, total, mean = lines[2].split()
    assert (name, calls) == ("matvec", "2")
    assert float(total) == pytest.approx(t.seconds("matvec"), abs=1e-4)
    assert float(mean) == pytest.approx(t.seconds("matvec") / 2 * 1e3, abs=1e-3)
