"""The general-mesh set-up's tensor route (``native``: geometry factors, node
keys, dof dedup, the box's cells; ``build_dofmap``,
``precompute_geometric_data``, ``facet_lumped_weights`` and
``GeneralOperators`` with ``device=``) against the JAX package, on the CPU
where the tensor route runs the kernels' plain versions.

Inputs come from ``np.random.default_rng``; everything is float64. The JAX
side takes its NumPy route (``use_native=False``, and meshes below the
native library's size thresholds), never its C++ library, which a parallel
test run may find half built. The card's side of the same checks is in
``tests/test_torch_gpu.py``.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import max_rel
from wave_fenics_tpu.benchmarks import general_solve as jgeneral_solve
from wave_fenics_tpu.core import geometry as jgeometry
from wave_fenics_tpu.core.dofmap import build_dofmap as jbuild_dofmap
from wave_fenics_tpu.core.mesh import HexMesh as JHexMesh
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.models.general_wave import GeneralLinearWave as JGeneralLinearWave
from wave_fenics_tpu.models.general_wave import facet_lumped_weights as jfacet_weights
from wave_fenics_tpu.ops.operators import GeneralOperators as JGeneralOperators
from wave_fenics_tpu_torch import native
from wave_fenics_tpu_torch.convert import general_mesh_from_numpy
from wave_fenics_tpu_torch.core import geometry
from wave_fenics_tpu_torch.core.basis import clamp_table
from wave_fenics_tpu_torch.core.dofmap import build_dofmap
from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave, facet_lumped_weights
from wave_fenics_tpu_torch.ops import _cuda
from wave_fenics_tpu_torch.ops import gather_scatter as gs
from wave_fenics_tpu_torch.ops.operators import GeneralOperators

F64 = torch.float64
CPU = torch.device("cpu")
EXTENT = (1.0, 0.8, 0.9)
SHEAR = np.array([[1.0, 0.3, 0.1], [0.0, 0.9, 0.2], [0.0, 0.0, 1.1]])
#: G to 1e-13 of max|G| and detJw to 1e-15 relative: the adjugate inverse
#: against np.linalg.inv, and the sums' order, differ by a few ulps
G_TOL, DETJW_TOL = 1e-13, 1e-15
#: dof coordinates of the first node against the NumPy route's last one
COORDS_TOL = 1e-15


def _jax_mesh(kind, cells, seed=0):
    """'perturbed' (interior vertices jittered by 0.02, seeded), 'sheared'
    (affine cells) or 'box'."""
    hm = jbox_mesh(cells, EXTENT).to_hex_mesh()
    pts = hm.points.copy()
    if kind == "perturbed":
        inner = np.all((pts > 1e-9) & (pts < np.asarray(EXTENT) - 1e-9), axis=1)
        pts[inner] += 0.02 * np.random.default_rng(seed).standard_normal(pts[inner].shape)
    elif kind == "sheared":
        pts = pts @ SHEAR.T
    return JHexMesh(points=pts, cells=hm.cells)


def _port_mesh(jmesh):
    mesh, _ = general_mesh_from_numpy(jmesh.points, jmesh.cells)
    return mesh


def _clamp_decisions(G):
    """Which entries clamp_table snaps (to -1, 0 or 1)."""
    G = np.asarray(G)
    return np.any([np.isclose(G, v, rtol=1e-5, atol=1e-8) for v in (-1.0, 0.0, 1.0)],
                  axis=0)


# -- the dofmap ---------------------------------------------------------------
@pytest.mark.parametrize("reorder", ["appearance", "morton", None])
@pytest.mark.parametrize("p", [1, 2, 4, 5])
@pytest.mark.parametrize("kind,cells", [("perturbed", (4, 3, 3)), ("box", (3, 2, 2))])
def test_build_dofmap_tensor_route_equals_jax(kind, cells, p, reorder):
    jm = _jax_mesh(kind, cells, seed=p)
    got = build_dofmap(_port_mesh(jm), p, reorder=reorder, device="cpu")
    want = jbuild_dofmap(jm, p, reorder=reorder)
    np.testing.assert_array_equal(got.dofmap, want.dofmap)
    assert got.ndofs == want.ndofs and got.dofmap.dtype == np.int32
    assert max_rel(got.dof_coords, want.dof_coords) <= COORDS_TOL
    if reorder == "morton":
        np.testing.assert_array_equal(got.cell_order, want.cell_order)
    np.testing.assert_array_equal(got.device_dofmap.numpy(), got.dofmap)
    # each dof's key is its first node's: the quantized dof coordinates
    scale = max(np.abs(jm.points).max(), 1.0)
    np.testing.assert_array_equal(got.device_keys.numpy(),
                                  np.rint(got.dof_coords * (1.0 / (scale * 1e-9))))


def test_node_keys_plain_quantizes_as_build_dofmap():
    """keys = rint(x / (scale tol)) of the nodes, x the trilinear map in
    basix vertex order; the coordinates within an ulp of NumPy's matmul."""
    jm = _jax_mesh("perturbed", (3, 2, 2), seed=3)
    cc = torch.as_tensor(jm.cell_coords())
    phi = torch.as_tensor(np.random.default_rng(4).random((27, 8)))
    keys, coords = native.node_keys(cc, phi, 2.0, 1e-9)
    ref = np.matmul(phi.numpy(), jm.cell_coords()).reshape(-1, 3)
    assert keys.dtype == torch.int64 and keys.shape == (12 * 27, 3)
    assert max_rel(coords, ref) <= 1e-15
    np.testing.assert_array_equal(keys.numpy(), np.rint(coords.numpy() * (1.0 / 2e-9)))


@pytest.mark.parametrize("lo,hi,n", [(0, 6, 5000), (-3, 3, 2000), (-10**12, 10**12, 300)])
def test_dedup_numbers_by_first_appearance(lo, hi, n):
    """The counterpart of tests/test_native.py's dedup test, held to the
    numbering itself: ids by first appearance, as wavecore's serial hash
    gives them."""
    keys = np.random.default_rng(n).integers(lo, hi, size=(n, 3))
    ids, ndofs, first = native.dedup_dofs(torch.as_tensor(keys), return_first=True)
    seen, want = {}, []
    for k in map(tuple, keys):
        want.append(seen.setdefault(k, len(seen)))
    assert ndofs == len(seen) and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_array_equal(ids[first].numpy(), np.arange(ndofs))
    assert (first.diff() > 0).all()


def test_dedup_table_size_is_a_power_of_two_of_at_least_twice_n():
    for n in (0, 1, 511, 512, 513, 4_276_737 * 2, 350_000_000):
        s = native.dedup_table_size(n)
        assert s >= max(2 * n, 1024) and s & (s - 1) == 0 and s < max(4 * n, 2048)


# -- geometry ----------------------------------------------------------------
@pytest.mark.parametrize("kind,p,q,rule", [
    ("perturbed", 1, None, "gll"), ("perturbed", 2, None, "gll"),
    ("perturbed", 4, None, "gll"), ("perturbed", 2, None, "gauss"),
    ("perturbed", 3, 8, "gauss"), ("box", 4, None, "gll"), ("box", 2, None, "gauss"),
])
def test_geometry_tensor_route_matches_jax(kind, p, q, rule):
    """G within 1e-13 of max|G|, detJw within 1e-15 relative, clamped and
    not; no entry whose clamp decision differs between the routes."""
    jm = _jax_mesh(kind, (3, 3, 2), seed=7)
    pm = _port_mesh(jm)
    for clamp in (True, False):
        G, detJw = geometry.precompute_geometric_data(pm, p, q, rule, clamp=clamp,
                                                      device="cpu")
        jG, jdetJw = jgeometry.precompute_geometric_data(jm, p, q, rule, clamp=clamp,
                                                         use_native=False)
        assert G.dtype == F64 and G.shape == jG.shape and detJw.shape == jdetJw.shape
        assert max_rel(G, jG) <= G_TOL and max_rel(detJw, jdetJw) <= DETJW_TOL
        if not clamp:
            mismatches = int((_clamp_decisions(G) != _clamp_decisions(jG)).sum())
            assert mismatches == 0
            np.testing.assert_array_equal(native.clamp_plain(G).numpy(),
                                          clamp_table(G.numpy()))


def test_singular_mesh_raises():
    """A flat cell (every vertex at z = 0) has det J = 0 at every point."""
    hm = jbox_mesh((2, 1, 1), EXTENT).to_hex_mesh()
    pts = hm.points.copy()
    pts[:, 2] = 0.0
    pm, _ = general_mesh_from_numpy(pts, hm.cells)
    with pytest.raises(ValueError, match="singular Jacobian in mesh"):
        geometry.precompute_geometric_data(pm, 2, device="cpu")
    with pytest.raises(ValueError, match="singular Jacobian in mesh"):
        GeneralOperators(pm, build_dofmap(pm, 2, device="cpu"), dtype=F64, device="cpu")


# -- the facet weights, the operators, the model -------------------------------
@pytest.mark.parametrize("rule", ["gll", "gauss"])
@pytest.mark.parametrize("p", [2, 3])
def test_facet_weights_tensor_route_match_jax(rule, p):
    jm, jtags = jgeneral_solve.perturbed_box((4, 3, 2))
    mesh, tags = general_mesh_from_numpy(jm.points, jm.cells, jtags)
    dofs = build_dofmap(mesh, p, device="cpu")
    for tag in (1, 2):
        got = facet_lumped_weights(mesh, dofs, tags[tag], p, rule=rule, device="cpu")
        want = jfacet_weights(jm, jbuild_dofmap(jm, p), jtags[tag], p, rule=rule)
        assert got.dtype == F64 and max_rel(got, want) <= 1e-13


def test_unmatched_facet_raises_on_both_routes():
    """A facet with a vertex off its face: its centre node (p = 2) is no
    dof of the mesh."""
    jm, jtags = jgeneral_solve.perturbed_box((3, 2, 2))
    mesh, tags = general_mesh_from_numpy(jm.points, jm.cells, jtags)
    bad = tags[1][:1].copy()
    bad[0, 3] = mesh.cells[-1, 7]
    with pytest.raises(ValueError, match="does not coincide with a volume dof"):
        facet_lumped_weights(mesh, build_dofmap(mesh, 2, device="cpu"), bad, 2,
                             device="cpu")
    with pytest.raises(ValueError, match="does not coincide with a volume dof"):
        facet_lumped_weights(mesh, build_dofmap(mesh, 2), bad, 2)


def test_facet_weights_on_a_device_need_a_dofmap_built_there():
    jm, jtags = jgeneral_solve.perturbed_box((3, 2, 2))
    mesh, tags = general_mesh_from_numpy(jm.points, jm.cells, jtags)
    with pytest.raises(ValueError, match="keys of a dofmap built there"):
        facet_lumped_weights(mesh, build_dofmap(mesh, 2), tags[1], 2, device="cpu")


@pytest.mark.parametrize("kind,rule,coeff", [("perturbed", "gll", False),
                                             ("perturbed", "gauss", False),
                                             ("perturbed", "gll", True),
                                             ("sheared", "gll", False)])
def test_general_operators_tensor_route_match_jax(kind, rule, coeff):
    """The lumped mass within 1e-12 of JAX's and of the NumPy route's; the
    affine flag and K's tables as the NumPy route's."""
    jm = _jax_mesh(kind, (4, 3, 2), seed=11)
    pm = _port_mesh(jm)
    cc = (1.0 + np.random.default_rng(5).random(jm.cells.shape[0])) if coeff else None
    jo = JGeneralOperators(jm, jbuild_dofmap(jm, 3), dtype=jnp.float64, rule=rule,
                           coeff_cells=cc)
    to = GeneralOperators(pm, build_dofmap(pm, 3, device="cpu"), dtype=F64, rule=rule,
                          coeff_cells=cc, device="cpu")
    ref = GeneralOperators(pm, build_dofmap(pm, 3), dtype=F64, rule=rule, coeff_cells=cc)
    assert max_rel(to.lumped_mass, np.asarray(jo.lumped_mass)) <= 1e-12
    assert max_rel(to.lumped_mass, ref.lumped_mass) <= 1e-12
    assert to.affine == ref.affine == (kind == "sheared")
    mode = "stiffness" if rule == "gll" else "stiffness_gauss"
    t, r = to.tables(mode, CPU), ref.tables(mode, CPU)
    assert max_rel(t.geo, r.geo) <= G_TOL and torch.equal(t.dofmap, r.dofmap)
    x = torch.as_tensor(np.random.default_rng(12).standard_normal(to.ndofs))
    assert max_rel(to.stiffness(x, 1.5), ref.stiffness(x, 1.5)) <= 1e-12
    assert max_rel(to.mass(x), ref.mass(x)) <= 1e-12


@pytest.mark.parametrize("quadrature", ["gll", "gauss"])
@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_general_wave_tensor_route_solve_matches_jax(integrator, quadrature):
    """The model (built on the CPU's tensor route): m, W1, W2 and a short
    solve within 1e-12 of the JAX package's."""
    jm, jtags = jgeneral_solve.perturbed_box((4, 2, 2))
    mesh, tags = general_mesh_from_numpy(jm.points, jm.cells, jtags)
    tm = GeneralLinearWave(mesh, 2, tags, dtype=F64, device="cpu", quadrature=quadrature)
    jw = JGeneralLinearWave(mesh=jm, p=2, facet_tags=jtags, dtype=jnp.float64,
                            quadrature=quadrature)
    assert tm.dofs.device_keys is not None  # the tensor route
    for name in ("m", "W1", "W2"):
        assert max_rel(getattr(tm, name), np.asarray(getattr(jw, name))) <= 1e-12
    dt = 2e-8 if integrator == "rk4" else 1e-8
    u, v = tm.solve_n(0.0, dt, 6, integrator=integrator)
    ju, jv = jw.solve_n(0.0, dt, 6, integrator=integrator)
    assert max_rel(u, np.asarray(ju)) <= 1e-12 and max_rel(v, np.asarray(jv)) <= 1e-12


def test_two_tensor_route_builds_are_bitwise_equal():
    jm, jtags = jgeneral_solve.perturbed_box((3, 2, 2))
    mesh, tags = general_mesh_from_numpy(jm.points, jm.cells, jtags)
    a, b = (GeneralLinearWave(mesh, 3, tags, dtype=F64, device="cpu") for _ in range(2))
    np.testing.assert_array_equal(a.dofs.dofmap, b.dofs.dofmap)
    np.testing.assert_array_equal(a.dofs.dof_coords, b.dofs.dof_coords)
    for name in ("m", "W1", "W2"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(a.ops._G, b.ops._G) and torch.equal(a.ops._detJw, b.ops._detJw)


def test_scatter_ordered_adds_in_add_at_order():
    rng = np.random.default_rng(21)
    ids = rng.integers(0, 50, 4000)
    vals = rng.standard_normal(4000) * 10.0 ** rng.integers(-8, 8, 4000)
    want = np.zeros(60)
    np.add.at(want, ids, vals)
    got = gs.scatter_ordered(torch.as_tensor(vals), torch.as_tensor(ids), 60)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the box's cells ---------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 2, 2), (1, 1, 1), (2, 5, 3)])
def test_box_cells_equal_jax_to_hex_mesh(shape):
    cells = native.box_cells(*shape)
    want = jbox_mesh(shape, EXTENT).to_hex_mesh().cells
    assert cells.dtype == torch.int64
    np.testing.assert_array_equal(cells.numpy(), want)


# -- dispatch and the C launchers ---------------------------------------------
def test_setup_wrappers_refuse_cpu_tensors_and_other_devices():
    cc = torch.zeros((2, 8, 3), dtype=F64)
    dphi, w = torch.zeros((3, 4, 8), dtype=F64), torch.ones(4, dtype=F64)
    keys = torch.zeros((5, 3), dtype=torch.int64)
    for call in (lambda: native.geometry_factors_cuda(cc, dphi, w),
                 lambda: native.node_keys_cuda(cc, dphi[0], 1.0, 1e-9),
                 lambda: native.dedup_dofs_cuda(keys)):
        with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
            call()
    meta = torch.zeros((2, 8, 3), dtype=F64, device="meta")
    with pytest.raises(ValueError, match="no implementation of geometry_factors"):
        native.geometry_factors(meta, dphi, w)
    with pytest.raises(ValueError, match="no implementation of dedup_dofs"):
        native.dedup_dofs(keys.to("meta"))


@pytest.mark.parametrize("nq", [1, 8, 125, 128, 343, 1331])
def test_geometry_launch_shape(nq):
    qt, cb, smem = native.geometry_launch_shape(nq)
    assert qt == min(nq, native.GEOMETRY_TILE) and qt * cb <= native.THREADS
    assert cb >= 1 and smem == (24 * (qt + cb) + 9 * qt * cb) * 8 <= 48 * 1024


def test_setup_launchers_match_the_c_signatures():
    """Each one-type launcher of csrc/setup_kernels.cu has as many C
    parameters as ctypes declares; geometry_launch_args fills them in the
    declared types."""
    src = (Path(_cuda.CSRC) / "setup_kernels.cu").read_text()
    for name, sig in _cuda._SETUP_SIGNATURES.items():
        proto = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src, re.S)
        params = [q for q in proto.group(1).split(",") if q.strip()]
        assert len(params) == len(sig) and sig[-1] is ctypes.c_void_p, name
        for q, k in zip(params, sig):
            if "*" in q or "cudaStream_t" in q:
                assert k is ctypes.c_void_p, (name, q)
            elif "int64_t" in q or "unsigned long long" in q:
                assert k in (ctypes.c_int64, ctypes.c_uint64), (name, q)
            elif "double" in q:
                assert k is ctypes.c_double, (name, q)
            else:
                assert k is ctypes.c_int, (name, q)
    cc, dphi, w = torch.zeros((3, 8, 3), dtype=F64), torch.zeros((3, 27, 8)), torch.ones(27)
    args = native.geometry_launch_args(cc, dphi, w, True, cc, w, w)
    kinds = {ctypes.c_void_p: torch.Tensor, ctypes.c_int: int, ctypes.c_int64: int}
    sig = _cuda._SETUP_SIGNATURES["wave_geometry_factors"]
    assert len(args) + 1 == len(sig)
    for a, k in zip(args, sig):
        assert isinstance(a, kinds[k])


def test_hexmesh_points_feed_both_routes_unchanged():
    """The tensor route reads the mesh and leaves it as it was."""
    jm = _jax_mesh("perturbed", (3, 2, 2), seed=2)
    pm = _port_mesh(jm)
    before = (pm.points.copy(), pm.cells.copy())
    GeneralOperators(pm, build_dofmap(pm, 2, device="cpu"), dtype=F64, device="cpu")
    np.testing.assert_array_equal(pm.points, before[0])
    np.testing.assert_array_equal(pm.cells, before[1])
