"""The explicit-dofmap path of the port (core.dofmap, the general geometry,
GeneralOperators with kernel K's plain version, GeneralLinearWave, the
assembled baseline) against the JAX package on the same meshes (float64,
CPU).

Meshes come from the JAX package's own helpers, perturbed with a numpy
seed, and cross to the port as NumPy arrays (``convert.
general_mesh_from_numpy``). Kernel K itself runs only on a card; its plain
version, which the CPU dispatch takes, is checked here against the JAX
indexed path and against the JAX TPU kernel in Pallas interpret mode, and
the CUDA kernel against the plain version in test_torch_gpu.py."""

import functools
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
from wave_fenics_tpu.ops import assembled as jassembled
from wave_fenics_tpu.ops.operators import GeneralOperators as JGeneralOperators
from wave_fenics_tpu_torch.benchmarks import general_solve
from wave_fenics_tpu_torch.convert import general_mesh_from_numpy
from wave_fenics_tpu_torch.core import geometry
from wave_fenics_tpu_torch.core.dofmap import build_dofmap
from wave_fenics_tpu_torch.core.mesh import box_mesh
from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave, facet_lumped_weights
from wave_fenics_tpu_torch.ops import assembled, general
from wave_fenics_tpu_torch.ops import gather_scatter as gs
from wave_fenics_tpu_torch.ops.operators import GeneralOperators

F64 = torch.float64
TOL = 1e-12  # f64, relative to max |ref|: only association order differs
EXTENT = (1.0, 0.8, 0.9)
SHEAR = np.array([[1.0, 0.3, 0.1], [0.0, 0.9, 0.2], [0.0, 0.0, 1.1]])


def _jax_mesh(kind, cells, seed=0):
    """A JAX HexMesh: 'perturbed' (interior vertices jittered by 0.02,
    seeded), 'sheared' (a parallelepiped map of the box: affine cells) or
    'box'."""
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


@functools.lru_cache(maxsize=None)
def _ops_pair(kind, p, rule, coeff=False):
    """(JAX GeneralOperators, port GeneralOperators) on the same mesh."""
    jm = _jax_mesh(kind, (4, 3, 2), seed=p)
    cc = (1.0 + np.random.default_rng(5).random(jm.cells.shape[0])) if coeff else None
    jo = JGeneralOperators(jm, jbuild_dofmap(jm, p), dtype=jnp.float64, rule=rule,
                           coeff_cells=cc)
    m = _port_mesh(jm)
    to = GeneralOperators(m, build_dofmap(m, p), dtype=F64, rule=rule, coeff_cells=cc)
    return jo, to


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("shape", [(3, 2, 4), (1, 1, 1), (5, 3, 2)])
def test_to_hex_mesh_equal(shape):
    a = box_mesh(shape, EXTENT, (0.1, 0.0, -0.2)).to_hex_mesh()
    b = jbox_mesh(shape, EXTENT, (0.1, 0.0, -0.2)).to_hex_mesh()
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.cells, b.cells)
    assert a.cells.dtype == b.cells.dtype
    assert a.hmin() == b.hmin()


@pytest.mark.parametrize("reorder", ["appearance", "morton", None])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_build_dofmap_equal(p, reorder):
    jm = _jax_mesh("perturbed", (4, 3, 3), seed=p)
    got = build_dofmap(_port_mesh(jm), p, reorder=reorder)
    want = jbuild_dofmap(jm, p, reorder=reorder)
    np.testing.assert_array_equal(got.dofmap, want.dofmap)
    np.testing.assert_array_equal(got.dof_coords, want.dof_coords)
    assert got.ndofs == want.ndofs and got.dofmap.dtype == np.int32
    if reorder == "morton":
        np.testing.assert_array_equal(got.cell_order, want.cell_order)


@pytest.mark.parametrize("p,q,rule", [(1, None, "gll"), (2, None, "gll"), (4, None, "gll"),
                                      (2, None, "gauss"), (3, 8, "gauss")])
def test_precompute_geometric_data_matches_jax(p, q, rule):
    jm = _jax_mesh("perturbed", (3, 3, 2), seed=7)
    G, detJw = geometry.precompute_geometric_data(_port_mesh(jm), p, q, rule)
    jG, jdetJw = jgeometry.precompute_geometric_data(jm, p, q, rule, use_native=False)
    assert max_rel(G, jG) <= 1e-14 and max_rel(detJw, jdetJw) <= 1e-14


@pytest.mark.parametrize("rule", ["gll", "gauss"])
def test_facet_lumped_weights_match_jax(rule):
    jm, jtags = jgeneral_solve.perturbed_box((4, 3, 2))
    mesh, tags = general_mesh_from_numpy(jm.points, jm.cells, jtags)
    for tag in (1, 2):
        got = facet_lumped_weights(mesh, build_dofmap(mesh, 3), tags[tag], 3, rule=rule)
        want = jfacet_weights(jm, jbuild_dofmap(jm, 3), jtags[tag], 3, rule=rule)
        assert max_rel(got, want) <= 1e-13


def test_perturbed_box_equal():
    got, gtags = general_solve.perturbed_box((4, 3, 2))
    want, wtags = jgeneral_solve.perturbed_box((4, 3, 2))
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.cells, want.cells)
    for tag in (1, 2):
        np.testing.assert_array_equal(gtags[tag], wtags[tag])
    assert general_solve.min_edge(got) == jgeneral_solve.min_edge(want)


def _jax_op(jo, op, xj):
    """The JAX indexed path that is ``op``'s reference."""
    return {
        "mass": jo.mass_indexed,
        "mass_indexed": jo.mass_indexed,
        "stiffness": lambda a: jo.stiffness_indexed(a, 1500.0),
        "stiffness_indexed": lambda a: jo.stiffness_indexed(a, 1500.0),
        "spectral_mass": jo.spectral_mass,
        "spectral_mass_roundtrip": jo.spectral_mass_roundtrip,
    }[op](xj)


GLL_OPS = ["mass", "mass_indexed", "stiffness", "stiffness_indexed", "spectral_mass",
           "spectral_mass_roundtrip"]
CASES = [("perturbed", False), ("perturbed", True), ("sheared", False)]


@pytest.mark.parametrize("kind,coeff", CASES, ids=["perturbed", "coeff_cells", "affine"])
@pytest.mark.parametrize("rule,op", [("gll", op) for op in GLL_OPS]
                         + [("gauss", op) for op in GLL_OPS[:4]])
def test_general_operator_matches_jax_indexed(rule, op, kind, coeff):
    """Every op (``mass`` and ``stiffness``: kernel K's plain version on the
    CPU) against the JAX indexed path, both rules, with a per-cell
    coefficient and on affine cells (the rank-1 geometry of K's tables)."""
    jo, to = _ops_pair(kind, 2, rule, coeff)
    assert to.affine == (jo._affine_small is not None) == (kind == "sheared" and rule == "gll")
    x = _x(to.ndofs, 11)
    args = (1500.0,) if "stiffness" in op else ()
    got = getattr(to, op)(torch.as_tensor(x), *args)
    assert max_rel(got, _jax_op(jo, op, jnp.asarray(x))) <= TOL


def test_lumped_mass_equal():
    for rule in ("gll", "gauss"):
        jo, to = _ops_pair("perturbed", 2, rule)
        np.testing.assert_array_equal(to.lumped_mass, jo.lumped_mass)


@pytest.mark.parametrize("p", [1, 4])
def test_kernel_k_modes_plain_match_jax_at_p(p):
    """Kernel K's plain version in all four modes at p = 1 and 4 against
    the JAX indexed path; the 0-d tensor c0 as the float."""
    for rule in ("gll", "gauss"):
        jo, to = _ops_pair("perturbed", p, rule)
        x = _x(to.ndofs, 12)
        xt = torch.as_tensor(x)
        assert max_rel(to.mass(xt), jo.mass_indexed(jnp.asarray(x))) <= TOL
        want = jo.stiffness_indexed(jnp.asarray(x), 1500.0)
        assert max_rel(to.stiffness(xt, 1500.0), want) <= TOL
        assert max_rel(to.stiffness(xt, torch.tensor(1500.0, dtype=F64)), want) <= TOL


@pytest.mark.parametrize("op", ["stiffness", "mass"])
def test_plain_matches_jax_fused_kernel_interpret(op):
    """Kernel K's plain version against the JAX TPU kernel itself (Pallas
    interpret mode on the CPU), p = 2 on a perturbed (5, 4, 3)-cell mesh."""
    jm = _jax_mesh("perturbed", (5, 4, 3), seed=2)
    jo = JGeneralOperators(jm, jbuild_dofmap(jm, 2), dtype=jnp.float64)
    m = _port_mesh(jm)
    to = GeneralOperators(m, build_dofmap(m, 2), dtype=F64)
    x = _x(to.ndofs, 13)
    if op == "stiffness":
        want = jo.stiffness_fused(jnp.asarray(x), 1500.0)
        got = to.stiffness(torch.as_tensor(x), 1500.0)
    else:
        want = jo.spectral_mass_fused(jnp.asarray(x))
        got = to.mass(torch.as_tensor(x))
    assert max_rel(got, want) <= TOL


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
@pytest.mark.parametrize("quadrature", ["gll", "gauss"])
def test_general_wave_solve_n_matches_jax(quadrature, integrator):
    jm, jtags = jgeneral_solve.perturbed_box((4, 3, 2))
    mesh, tags = general_mesh_from_numpy(jm.points, jm.cells, jtags)
    tm = GeneralLinearWave(mesh, 2, tags, dtype=F64, device="cpu", quadrature=quadrature)
    jw = JGeneralLinearWave(mesh=jm, p=2, facet_tags=jtags, dtype=jnp.float64,
                            quadrature=quadrature)
    dt = 0.5 * general_solve.min_edge(mesh) / (1500.0 * 4)
    if integrator == "leapfrog":
        dt *= general_solve.LEAPFROG_DT
    u, v = tm.solve_n(0.0, dt, 12, integrator=integrator)
    ju, jv = jw.solve_n(0.0, dt, 12, integrator=integrator)
    assert max_rel(u, ju) <= TOL and max_rel(v, jv) <= TOL
    for name in ("m", "inv_m", "W1", "W2", "damping"):
        assert max_rel(getattr(tm, name), getattr(jw, name)) <= 1e-13


def test_general_wave_c0_cells_matches_jax():
    jm, jtags = jgeneral_solve.perturbed_box((4, 3, 2))
    mesh, tags = general_mesh_from_numpy(jm.points, jm.cells, jtags)
    c0c = 1500.0 * (1.0 + 0.2 * np.random.default_rng(3).random(mesh.ncells))
    tm = GeneralLinearWave(mesh, 2, tags, dtype=F64, device="cpu", c0_cells=c0c)
    jw = JGeneralLinearWave(mesh=jm, p=2, facet_tags=jtags, dtype=jnp.float64, c0_cells=c0c)
    x = _x(tm.ndofs, 16)
    assert max_rel(tm.f1(1e-7, torch.as_tensor(x), torch.as_tensor(x)),
                   jw.f1(1e-7, jnp.asarray(x), jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("kind", ["mass", "stiffness"])
def test_assembled_csr_matches_jax_and_the_matrix_free_op(kind):
    jm = _jax_mesh("perturbed", (3, 2, 2), seed=4)
    m = _port_mesh(jm)
    dofs = build_dofmap(m, 2)
    A_e = assembled.assemble_element_tensors(m, 2, kind=kind, coeff=-2.0)
    jA_e = jassembled.assemble_element_tensors(jm, 2, kind=kind, coeff=-2.0)
    assert max_rel(A_e, jA_e) <= 1e-14
    A = assembled.assemble_csr(dofs, A_e)
    x = _x(dofs.ndofs, 17)
    assert max_rel(A @ x, jassembled.assemble_csr(jbuild_dofmap(jm, 2), jA_e) @ x) <= 1e-14
    # the torch CSR matvec against the matrix-free op on the clamped geometry
    ops = GeneralOperators(m, dofs, dtype=F64)
    Ac = assembled.assemble_csr(dofs, assembled.assemble_element_tensors(
        m, 2, kind=kind, coeff=-2.0, clamp=True))
    y = torch.sparse.mm(assembled.csr_tensor(Ac, "cpu", F64), torch.as_tensor(x)[:, None])
    ref = (ops.stiffness(torch.as_tensor(x), 2.0**0.5) if kind == "stiffness"
           else -2.0 * ops.mass(torch.as_tensor(x)))
    assert max_rel(y[:, 0], ref) <= TOL


@pytest.mark.parametrize("op", ["mass", "stiffness"])
def test_non_cpu_tensors_do_not_take_the_plain_path(op):
    _, to = _ops_pair("perturbed", 2, "gll")
    meta = torch.empty(to.ndofs, dtype=F64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        getattr(to, op)(meta)


def test_kernel_k_wrapper_refuses_cpu_tensors_and_its_limits():
    """The kernel wrapper never runs the plain version; K raises for p > 6
    and for a Gauss rule whose cell buffers do not fit shared memory."""
    _, to = _ops_pair("perturbed", 2, "gll")
    tables = to.tables("stiffness", torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        general.general_apply_cuda(torch.zeros(to.ndofs, dtype=F64), tables)
    with pytest.raises(ValueError, match="p <= 6"):
        general.launch_shape("stiffness", 8, 8, 8)
    with pytest.raises(ValueError, match="shared memory"):
        general.launch_shape("stiffness_gauss", 7, 20, 8)
    assert general.launch_shape("stiffness_gauss", 7, 7, 8)[2] <= general.SMEM_LIMIT


@pytest.mark.parametrize("p", range(1, 7))
def test_kernel_k_column_launch_shape(p):
    """The collocated stiffness runs one thread per (j, k) column of a cell,
    csrc/general_kernels.cu's kColumnThreads // m^2 cells a block (10 at
    p = 4); its x_e, w_1, w_2 and D fit the 48 KB of static shared memory
    in f64, far under an H100 block's 232,448 bytes."""
    m = p + 1
    src = (Path(general._cuda.CSRC) / "general_kernels.cu").read_text()
    threads = int(re.search(r"constexpr int kColumnThreads = (\d+);", src).group(1))
    assert threads == general.COLUMN_THREADS
    for itemsize in (4, 8):
        cpb, stride, smem = general.launch_shape("stiffness", m, m, itemsize)
        assert cpb == max(1, threads // m**2) and stride == 3 * m**3
        assert m * m <= cpb * m * m <= threads
        assert smem == (cpb * 3 * m**3 + m * m) * itemsize
        assert smem <= 48 * 1024 <= general.SMEM_LIMIT
    assert general.launch_shape("stiffness", 5, 5, 4)[0] == 10


@pytest.mark.parametrize("mode", general.MODES)
def test_kernel_k_raises_at_p7(mode):
    """Kernel K takes p <= 6 in every mode: p = 7 raises before a launch."""
    with pytest.raises(ValueError, match="p <= 6"):
        general.launch_shape(mode, 8, 8 if mode.endswith("_gauss") else 8, 8)


def _shuffled(jm, seed):
    perm = np.random.default_rng(seed).permutation(jm.cells.shape[0])
    return JHexMesh(points=jm.points, cells=jm.cells[perm])


@pytest.mark.parametrize("kind", ["perturbed", "shuffled"])
def test_colouring_is_conflict_free_and_covers_every_cell_once(kind):
    """No two cells of one colour share a dof, and every cell has exactly
    one colour; on the box's C-ordered cells the greedy colouring is the
    parity colouring (8 colours); on shuffled cells it still holds."""
    jm = _jax_mesh("perturbed", (5, 4, 3), seed=1)
    if kind == "shuffled":
        jm = _shuffled(jm, 2)
    m = _port_mesh(jm)
    p = 2
    dm = build_dofmap(m, p).dofmap
    cells, starts = gs.colour_cells(dm, p + 1)
    nc = dm.shape[0]
    assert cells.dtype == starts.dtype == np.int32
    assert starts[0] == 0 and starts[-1] == nc and (np.diff(starts) > 0).all()
    np.testing.assert_array_equal(np.sort(cells), np.arange(nc))
    for lo, hi in zip(starts[:-1], starts[1:]):
        assert (np.diff(cells[lo:hi]) > 0).all()  # increasing within a colour
        dofs = dm[cells[lo:hi]].ravel()
        assert np.unique(dofs).size == dofs.size
    if kind == "perturbed":
        i, j, k = np.meshgrid(*(np.arange(n) for n in (5, 4, 3)), indexing="ij")
        parity = ((i % 2) * 4 + (j % 2) * 2 + k % 2).ravel()
        colour = np.empty(nc, dtype=int)
        for c, (lo, hi) in enumerate(zip(starts[:-1], starts[1:])):
            colour[cells[lo:hi]] = c
        np.testing.assert_array_equal(colour, parity)


def test_colouring_is_the_same_on_every_build():
    """Two builds of the same operator give the same colouring, so the sum
    order of kernel K's scatter, and its result, do not depend on the run."""
    jm = _shuffled(_jax_mesh("perturbed", (4, 3, 2), seed=3), 4)
    m = _port_mesh(jm)
    a = GeneralOperators(m, build_dofmap(m, 2), dtype=F64).colouring
    b = GeneralOperators(m, build_dofmap(m, 2), dtype=F64).colouring
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    t = GeneralOperators(m, build_dofmap(m, 2), dtype=F64).tables("stiffness", "cpu")
    np.testing.assert_array_equal(t.cells.numpy(), a[0])
    np.testing.assert_array_equal(t.colour_starts.numpy(), a[1])
    assert t.colour_starts.device.type == "cpu" and t.ncolours == a[1].size - 1


@pytest.mark.parametrize("mode", general.MODES)
def test_general_apply_plain_in_colour_order_matches_jax(mode):
    """general_apply_plain (the element kernel, then the scatter in kernel
    K's colour order) in each of the four modes against the JAX package's
    indexed general apply, f64, on a perturbed mesh at p = 3."""
    rule = "gauss" if mode.endswith("_gauss") else "gll"
    jo, to = _ops_pair("perturbed", 3, rule)
    x = _x(to.ndofs, 18)
    coeff = -1500.0**2 if mode.startswith("stiffness") else 1.0
    got = general.general_apply_plain(torch.as_tensor(x), to.tables(mode, "cpu"), coeff)
    want = (jo.stiffness_indexed(jnp.asarray(x), 1500.0) if mode.startswith("stiffness")
            else jo.mass_indexed(jnp.asarray(x)))
    assert max_rel(got, want) <= TOL


def test_scatter_coloured_matches_the_indexed_add():
    """The coloured scatter sums every element entry into its dof once:
    the indexed add's result to rounding; the gather reads x[dofmap]."""
    _, to = _ops_pair("perturbed", 2, "gll")
    t = to.tables("mass", "cpu")
    ye = torch.as_tensor(_x(to._dofmap.shape, 19))
    y = gs.scatter_coloured(ye, t.dofmap, t.cells, t.colour_starts, to.ndofs)
    assert max_rel(y, gs.scatter_indexed(ye, t.dofmap, to.ndofs)) <= 1e-15
    np.testing.assert_array_equal(gs.gather_indexed(torch.as_tensor(_x(to.ndofs, 15)),
                                                    t.dofmap).numpy(),
                                  _x(to.ndofs, 15)[to._dofmap])


def test_kernel_k_launch_args_match_the_c_signature():
    """general.launch_args builds the argument list whose types ctypes
    declares for ``wave_general_apply`` (the host colour_starts as a
    pointer), with as many entries as the C prototype has parameters."""
    import ctypes

    _, to = _ops_pair("perturbed", 2, "gll")
    t = to.tables("stiffness", "cpu")
    x = torch.zeros(to.ndofs, dtype=F64)
    out = torch.empty_like(x)
    args = general.launch_args(x, out, t, -2.0)
    sig = general._cuda._SIGNATURES["wave_general_apply"]
    kinds = {ctypes.c_void_p: (torch.Tensor, type(None)), ctypes.c_int: int,
             ctypes.c_double: float}
    assert len(args) + 1 == len(sig) and sig[-1] is ctypes.c_void_p  # + stream
    for a, k in zip(args, sig):
        assert isinstance(a, kinds[k])
    assert args[2] is out  # f64 accumulates in y itself (bf16: a float32 workspace)
    assert args[5] is t.colour_starts and args[6] == t.ncolours
    assert args[-4:-1] == general.launch_shape("stiffness", 3, 3, 8)
    src = (Path(general._cuda.CSRC) / "general_kernels.cu").read_text()
    proto = re.search(r'extern "C" int wave_general_apply_##SUFFIX\((.*?)\)\s*\{', src, re.S)
    params = [q for q in proto.group(1).replace("\\", " ").split(",") if q.strip()]
    assert len(params) == len(sig)
