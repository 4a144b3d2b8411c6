"""bf16 state on kernels G and K, the imported-mesh model, CG and the
benchmarks, against the JAX package on the CPU.

The JAX side runs in bf16 as its own tests run it: the BP1 mass kernel
(``make_mass_apply``) in Pallas interpret mode off the TPU, the general
operators through their indexed paths (the ones its CPU dispatch takes).
The port runs its plain bf16 twins (bf16 storage, float32 arithmetic, one
rounding where a kernel stores; kernel K's colours add in float32 and y is
rounded once).

Tolerances, relative to max|ref|:

- tables: bit for bit (G's cvx, cvy, cvz and M1; K's B, D, G and |det J| w
  per node, and the affine cells' g6);
- one apply against JAX's bf16 kernel or operator: 2e-2. Each package is
  a few bf16 ulps (2^-8) from float64 and they round at other places: the
  JAX package's own bf16 error against float64 reaches 1.5e-2 (G at p = 8)
  and 1.2e-2 (K's stiffness_gauss), so the 1e-2 of the box kernels'
  tests cannot hold here;
- one apply against JAX's float64 answer: within 1.5x the JAX package's
  own bf16 error against it, and within the benchmarks' ``--check`` limit
  (``common.BF16_CHECK_TOL``, 2e-2);
- a 50-step solve, and CG after the same kmax: the relative L2 error
  against JAX's float64 answer at most 1.5x that of the JAX package's own
  bf16 solve (RATIO).

The JAX package's bf16 ``GeneralLinearWave`` cannot be built: its lumped
mass is a NumPy einsum over bf16 arrays, which NumPy refuses (strict xfail
below). Its yardstick solve here takes that lumped mass computed in float64
and rounded to bf16, set on its operators before the model reads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wave_fenics_tpu.benchmarks import general_solve as jgeneral_solve
from wave_fenics_tpu.core.dofmap import build_dofmap as jbuild_dofmap
from wave_fenics_tpu.core.mesh import HexMesh as JHexMesh
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.models.general_wave import GeneralLinearWave as JGeneralLinearWave
from wave_fenics_tpu.ops import pallas_mass as jpm
from wave_fenics_tpu.ops.operators import GeneralOperators as JGeneralOperators
from wave_fenics_tpu.ops.pallas_wave import PaddedLayout as JPaddedLayout
from wave_fenics_tpu.ops.separable import separable_mass_tables as j_mass_tables
from wave_fenics_tpu.solvers.cg import cg as jcg
from wave_fenics_tpu_torch import convert
from wave_fenics_tpu_torch.apps import bf16_growth
from wave_fenics_tpu_torch.benchmarks import (cg_bench, common, general_solve,
                                              operators_bench, scatter_bench, tsmm)
from wave_fenics_tpu_torch.core.dofmap import build_dofmap
from wave_fenics_tpu_torch.core.mesh import box_mesh
from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave
from wave_fenics_tpu_torch.ops import general, mass
from wave_fenics_tpu_torch.ops.operators import GeneralOperators
from wave_fenics_tpu_torch.ops.separable import separable_mass_tables
from wave_fenics_tpu_torch.solvers.cg import cg

BF16 = torch.bfloat16
ONE = 2e-2  # one apply against JAX's bf16 operator: max|err| / max|ref|
RATIO = 1.5  # against f64: at most 1.5x the JAX package's own bf16 error
NSTEPS = 50
EXTENT = (1.0, 0.8, 1.2)
GEXT = np.array([1.0, 0.8, 0.9])
SHEAR = np.array([[1.0, 0.3, 0.1], [0.0, 0.9, 0.2], [0.0, 0.0, 1.1]])


@pytest.fixture(autouse=True)
def _x64():
    """The f64 answers need JAX's x64 mode (the package's tests run in it)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _bits(a) -> np.ndarray:
    """A JAX bf16 array, a port bf16 tensor, or a port table (float64
    values of bf16) as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return convert.to_numpy_bits(a.to(BF16))
    if convert.is_bf16_array(np.asarray(a)):
        return np.asarray(a).view(np.uint16)
    return convert.to_numpy_bits(torch.as_tensor(np.asarray(a, np.float64)).to(BF16))


def _np(a) -> np.ndarray:
    return (a.double().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a).astype(np.float64))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- kernel G --------------------------------------------------------------------
G_CASES = [(1, (3, 2, 2)), (2, (3, 2, 2)), (4, (2, 2, 2)), (8, (2, 2, 2))]


def _g_pair(p, cells):
    """(JAX layout, port layout, h) of the BP1 mass on ``cells``."""
    grid = tuple(n * p + 1 for n in cells)
    tile = 32 if p == 1 else 16
    h = tuple(e / c for e, c in zip(EXTENT, cells))
    return (JPaddedLayout(grid, p, tile_x=tile, z_align=16), mass.mass_layout(grid, p, tile),
            h)


@pytest.mark.parametrize("p,cells", G_CASES)
def test_mass_tables_bit_for_bit(p, cells):
    """The port's bf16 M1 and its padded cvx, cvy, cvz are the JAX
    package's bf16 M1 and build_mass_tables' CVY, CVZ and WXT bands, bit
    for bit."""
    jlay, lay, h = _g_pair(p, cells)
    M1 = separable_mass_tables(p, h, BF16)
    jM1 = j_mass_tables(p, h, jnp.bfloat16)
    for a, b in zip(M1, jM1):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    cvx, cvy, cvz = mass.mass_tables(lay, M1, BF16)
    WXT, CVY, CVZ = jpm.build_mass_tables(jlay, jM1, jnp.bfloat16)
    Lx, Ly, Lz = lay.padded_shape
    np.testing.assert_array_equal(_bits(np.repeat(cvy, Lz, axis=1)), _bits(CVY))
    np.testing.assert_array_equal(_bits(np.tile(cvz, (1, Ly))), _bits(CVZ))
    Tx, K = lay.tile_x, 2 * p + 1
    wxt = np.asarray(WXT).view(np.uint16)
    for t in range(1, Lx // Tx - 1):
        for o in range(Tx):
            np.testing.assert_array_equal(wxt[t, o, o + 8 - p: o + 8 - p + K],
                                          _bits(cvx[:, t * Tx + o]))
    tabs = mass.mass_operator(lay.shape, p, M1, BF16, "cpu", tile_x=lay.tile_x)[1]
    assert all(t.dtype == BF16 for t in tabs)
    for got, want in zip(tabs, (cvx, cvy, cvz)):
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("p,cells", G_CASES)
def test_one_g_apply_matches_jax_kernel(p, cells):
    """One apply of JAX's bf16 BP1 mass kernel (interpret mode) against
    kernel G's plain twin (z, y, x) and the x, y, z plain version on the
    port's bf16 tables: within ONE of JAX's, the padding exactly 0, and
    against JAX's f64 answer within RATIO x JAX's own bf16 error."""
    jlay, lay, h = _g_pair(p, cells)
    x = np.zeros(lay.padded_shape)
    x[lay.interior] = np.random.default_rng(50 + p).standard_normal(lay.shape)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jpm.make_mass_apply(jlay, j_mass_tables(p, h, jnp.bfloat16), jnp.bfloat16)(jx)
    f64 = jpm.make_mass_apply(jlay, j_mass_tables(p, h, jnp.float64), jnp.float64)(
        jnp.asarray(np.asarray(jx).astype(np.float64)))
    tabs = mass.MassTables(*convert.tables_from_numpy(
        mass.mass_tables(lay, separable_mass_tables(p, h, BF16), BF16), "cpu", BF16))
    xb = convert.tables_from_numpy((np.asarray(jx),), "cpu", BF16)[0]
    yardstick = _rel(want, f64)
    for fn in (mass.mass_apply_zyx_plain, mass.mass_apply_plain):
        got = fn(xb, lay, tabs)
        assert got.dtype == BF16
        outside = got.clone()
        outside[lay.interior] = 0
        assert float(outside.abs().max()) == 0.0
        assert _rel(got, want) <= ONE
        err = _rel(got, f64)
        assert err <= max(RATIO * yardstick, 1e-3) and err <= common.BF16_CHECK_TOL


def test_mass_gauss_and_mass_fused_take_bf16():
    """StructuredOperators.mass_gauss (the separable twin) and mass_fused
    (kernel G's layout) in bf16 give the plain G twin's answer."""
    from wave_fenics_tpu_torch.ops.operators import StructuredOperators

    mesh = box_mesh((3, 2, 2), EXTENT)
    ops = StructuredOperators(mesh, 2, dtype=BF16)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(ops.grid_shape)).to(BF16)
    y = ops.mass_gauss(x)
    M1 = separable_mass_tables(2, mesh.h, BF16)
    yf = mass.mass_fused(x, M1, 2)
    assert y.dtype == yf.dtype == BF16
    assert _rel(y, yf) <= 1e-2


# -- kernel K --------------------------------------------------------------------
def _jax_mesh(kind, cells=(4, 3, 2), seed=0):
    hm = jbox_mesh(cells, tuple(GEXT)).to_hex_mesh()
    pts = hm.points.copy()
    if kind == "perturbed":
        inner = np.all((pts > 1e-9) & (pts < GEXT - 1e-9), axis=1)
        pts[inner] += 0.02 * np.random.default_rng(seed).standard_normal(pts[inner].shape)
    else:  # sheared: a parallelepiped map of the box, affine cells
        pts = pts @ SHEAR.T
    return JHexMesh(points=pts, cells=hm.cells)


def _k_pair(kind, p, rule):
    """(JAX bf16, JAX f64, port bf16) GeneralOperators on one mesh."""
    jm = _jax_mesh(kind, seed=p)
    d = jbuild_dofmap(jm, p)
    mesh, _ = convert.general_mesh_from_numpy(jm.points, jm.cells)
    return (JGeneralOperators(jm, d, dtype=jnp.bfloat16, rule=rule),
            JGeneralOperators(jm, d, dtype=jnp.float64, rule=rule),
            GeneralOperators(mesh, build_dofmap(mesh, p), dtype=BF16, rule=rule))


@pytest.mark.parametrize("kind", ["perturbed", "sheared"])
@pytest.mark.parametrize("p,rule", [(2, "gll"), (4, "gll"), (2, "gauss")])
def test_general_tables_bit_for_bit(kind, p, rule):
    """The port's bf16 B, D, G and |det J| w are the JAX package's bf16
    tables bit for bit, and so is every per-node value of kernel K's
    geometry (G's six entries, |det J| w); the affine cells' g6 and w are
    the float64 factors rounded once."""
    j16, j64, t16 = _k_pair(kind, p, rule)
    for got, want in ((t16._B, j16._B), (t16._D, j16._D), (t16._G, j16._G),
                      (t16._detJw, j16._detJw)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    nc = t16.mesh.ncells
    jG = np.asarray(j16._G).reshape(nc, -1, 3, 3)
    sym = np.stack([jG[:, :, a, b] for a, b in general.SYM])
    for mode in (("mass", "stiffness") if rule == "gll" else ("mass_gauss", "stiffness_gauss")):
        t = t16.tables(mode, "cpu")
        assert t.geo.dtype == t.B.dtype == BF16
        if t.affine:
            af = j64._affine_small
            want = af["dJ"][None] if mode == "mass" else af["g6"]
            np.testing.assert_array_equal(_bits(t.geo), _bits(want))
            assert t16.affine == (kind == "sheared")
        elif mode.startswith("mass"):
            np.testing.assert_array_equal(
                _bits(t.geo), np.asarray(j16._detJw).reshape(1, nc, -1).view(np.uint16))
        else:
            np.testing.assert_array_equal(_bits(t.geo), sym.view(np.uint16))


@pytest.mark.parametrize("kind", ["perturbed", "sheared"])
@pytest.mark.parametrize("mode", ["mass", "stiffness", "mass_gauss", "stiffness_gauss"])
@pytest.mark.parametrize("p", [2, 4])
def test_one_k_apply_matches_jax(kind, mode, p):
    """One apply of kernel K's plain bf16 twin in each mode (affine and
    non-affine cells) against the JAX package's bf16 operator (its indexed
    path) within ONE, against its f64 answer within RATIO x the JAX
    package's own bf16 error; two applies bitwise equal."""
    rule = "gauss" if mode.endswith("_gauss") else "gll"
    j16, j64, t16 = _k_pair(kind, p, rule)
    x = np.random.default_rng(3).standard_normal(t16.ndofs)
    jx = jnp.asarray(x, jnp.bfloat16)
    x16 = convert.tables_from_numpy((np.asarray(jx),), "cpu", BF16)[0]
    x64 = jnp.asarray(np.asarray(jx).astype(np.float64))
    if mode.startswith("mass"):
        want, f64 = j16.mass_indexed(jx), j64.mass_indexed(x64)
        got, got2 = t16.mass(x16), t16.mass(x16)
    else:
        want, f64 = j16.stiffness_indexed(jx, 1500.0), j64.stiffness_indexed(x64, 1500.0)
        got, got2 = t16.stiffness(x16, 1500.0), t16.stiffness(x16, 1500.0)
    assert t16.mode(mode.split("_")[0]) == mode and got.dtype == BF16
    assert torch.equal(got, got2)
    assert _rel(got, want) <= ONE
    err = _rel(got, f64)
    assert err <= RATIO * _rel(want, f64) and err <= common.BF16_CHECK_TOL


def test_k_twin_rounds_once_from_float32():
    """Kernel K's plain twin adds the colours in float32 and rounds y once:
    it equals the float32 twin on the same bf16 tables and x, rounded."""
    _, _, t16 = _k_pair("perturbed", 2, "gll")
    t = t16.tables("stiffness", "cpu")
    t32 = general.GeneralTables(t.mode, t.dofmap, t.cells, t.colour_starts, t.ndofs,
                                *(None if a is None else a.float() for a in (t.B, t.D, t.geo,
                                                                             t.w)))
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(t.ndofs)).to(BF16)
    y16 = general.general_apply_plain(x, t, -(1500.0**2))
    y32 = general.general_apply_plain(x.float(), t32, -(1500.0**2))
    assert torch.equal(y16, y32.to(BF16))


def test_k_launch_args_carry_a_float32_workspace():
    """For a bf16 x kernel K's launcher gets a float32 workspace of ndofs
    (not y), and the element launches' shared memory at 4 bytes a value."""
    _, _, t16 = _k_pair("perturbed", 2, "gauss")
    t = t16.tables("mass_gauss", "cpu")
    x = torch.zeros(t.ndofs, dtype=BF16)
    out = torch.empty_like(x)
    args = general.launch_args(x, out, t, 1.0)
    assert args[2].dtype == torch.float32 and args[2].shape == x.shape
    assert args[2].data_ptr() != out.data_ptr()
    assert args[-4:-1] == general.launch_shape("mass_gauss", t.m, t.nq, 4)


# -- the imported-mesh model -------------------------------------------------------
def _jax_bf16_model(jm, jtags, p, quadrature="gll"):
    """The JAX package's bf16 GeneralLinearWave, its lumped mass (which
    it cannot form in bf16) set to the float64 one rounded to bf16."""
    j64 = JGeneralOperators(jm, jbuild_dofmap(jm, p), dtype=jnp.float64, rule=quadrature)
    jw = JGeneralLinearWave(mesh=jm, p=p, facet_tags=jtags, dtype=jnp.bfloat16,
                            quadrature=quadrature)
    jw.ops.__dict__["lumped_mass"] = np.asarray(jnp.asarray(j64.lumped_mass, jnp.bfloat16))
    return jw


@pytest.fixture(scope="module")
def general_answers():
    """(mesh, tags, dt, {integrator: (JAX f64 u, v; JAX bf16 u, v)}) on the
    perturbed (4, 3, 2)-cell box at p = 2 over NSTEPS steps."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    jm, jtags = jgeneral_solve.perturbed_box((4, 3, 2))
    mesh, tags = convert.general_mesh_from_numpy(jm.points, jm.cells, jtags)
    dt = 0.5 * general_solve.min_edge(mesh) / (1500.0 * 4)
    j64 = JGeneralLinearWave(mesh=jm, p=2, facet_tags=jtags, dtype=jnp.float64)
    j16 = _jax_bf16_model(jm, jtags, 2)
    out = {}
    for integrator in ("rk4", "leapfrog"):
        d = dt * (general_solve.LEAPFROG_DT if integrator == "leapfrog" else 1.0)
        out[integrator] = (j64.solve_n(0.0, d, NSTEPS, integrator=integrator),
                           j16.solve_n(0.0, d, NSTEPS, integrator=integrator), d)
    jax.config.update("jax_enable_x64", prev)
    return mesh, tags, out


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_general_model_solve_within_the_jax_yardstick(integrator, general_answers):
    """A 50-step bf16 solve of the imported-mesh model (kernel K's twin):
    its relative L2 error against JAX's f64 answer at most RATIO x that of
    the JAX package's own bf16 solve_n (u and v)."""
    mesh, tags, answers = general_answers
    (ju, jv), (bu, bv), dt = answers[integrator]
    m = GeneralLinearWave(mesh, 2, tags, dtype=BF16, device="cpu")
    u, v = m.solve_n(0.0, dt, NSTEPS, integrator=integrator)
    assert u.dtype == v.dtype == BF16 and float(v.float().abs().max()) > 0
    eu, ev = _l2(u, ju), _l2(v, jv)
    assert eu <= RATIO * _l2(bu, ju) and ev <= RATIO * _l2(bv, jv), (
        eu, ev, _l2(bu, ju), _l2(bv, jv))


def test_general_model_buffers_round_where_jax_rounds():
    """W1 and W2 are the JAX bf16 model's bit for bit (float64 facet
    weights rounded once); m, summed in float64 from the bf16 tables and
    rounded once, is within one bf16 ulp of the float64 lumped mass rounded
    (the JAX package cannot form its own), and inv_m its bf16 reciprocal;
    the NumPy route gives the device route's (a CPU device) m bit for
    bit."""
    jm, jtags = jgeneral_solve.perturbed_box((4, 3, 2))
    mesh, tags = convert.general_mesh_from_numpy(jm.points, jm.cells, jtags)
    m = GeneralLinearWave(mesh, 2, tags, dtype=BF16, device="cpu")
    jw = _jax_bf16_model(jm, jtags, 2)
    for name in ("W1", "W2", "m", "inv_m"):
        assert getattr(m, name).dtype == BF16
    np.testing.assert_array_equal(_bits(m.W1), _bits(jw.W1))
    np.testing.assert_array_equal(_bits(m.W2), _bits(jw.W2))
    assert _rel(m.m, jw.m) <= 2.0**-8
    np.testing.assert_array_equal(_bits(m.inv_m), _bits((1.0 / m.m.double()).to(BF16)))
    ops_np = GeneralOperators(mesh, build_dofmap(mesh, 2), dtype=BF16)
    np.testing.assert_array_equal(_bits(ops_np.lumped_mass), _bits(m.m))


@pytest.mark.xfail(strict=True, raises=TypeError, reason=(
    "a fault of the reference: the JAX package's bf16 GeneralOperators.lumped_mass "
    "(ops/operators.py:336-345) is a NumPy einsum over bf16 arrays, which NumPy "
    "refuses, so its bf16 GeneralLinearWave cannot form m"))
def test_jax_bf16_general_model_builds():
    jm, jtags = jgeneral_solve.perturbed_box((4, 3, 2))
    JGeneralLinearWave(mesh=jm, p=2, facet_tags=jtags, dtype=jnp.bfloat16).m


def test_jax_bf16_general_stiffness_rounds_c0():
    """The JAX package's bf16 stiffness (``stiffness_indexed``, and the
    sharded ``_stiffness_local`` the same way) forms -c0^2 from c0 rounded to
    bf16, 1500 -> 1504: -2,260,992, 0.49 % above 2.25e6, a wave speed 0.24 %
    fast. The port keeps -c0^2 in float32."""
    c0 = jnp.asarray(1500.0, dtype=jnp.bfloat16)
    assert float(c0) == 1504.0 and float(-(c0**2)) == -2260992.0
    _, _, t16 = _k_pair("perturbed", 2, "gll")
    coeff = t16._coeff(torch.zeros(1, dtype=BF16), 1500.0)
    assert coeff.dtype == torch.float32 and float(coeff) == -2.25e6


# -- CG in bf16 --------------------------------------------------------------------
def _bp1_systems(p=2, cells=(3, 3, 3)):
    """(JAX bf16 matvec, JAX f64 matvec, port bf16 matvec, b padded (f64
    values of bf16), layout) of the BP1 mass."""
    mesh = box_mesh(cells, (1.0, 1.0, 1.0))
    grid = tuple(n * p + 1 for n in cells)
    jlay = JPaddedLayout(grid, p, tile_x=16, z_align=16)
    lay, tabs, _ = mass.bp1_setup(mesh, p, BF16, "cpu")
    b = np.zeros(lay.padded_shape)
    b[lay.interior] = np.random.default_rng(0).standard_normal(lay.shape)
    b = np.asarray(jnp.asarray(b, jnp.bfloat16)).astype(np.float64)
    return (jpm.make_mass_apply(jlay, j_mass_tables(p, mesh.h, jnp.bfloat16), jnp.bfloat16),
            jpm.make_mass_apply(jlay, j_mass_tables(p, mesh.h, jnp.float64), jnp.float64),
            lambda v: mass.mass_apply(v, lay, tabs), b)


def _general_mass_systems(p=2):
    jm = _jax_mesh("perturbed", seed=p)
    j16 = JGeneralOperators(jm, jbuild_dofmap(jm, p), dtype=jnp.bfloat16, rule="gauss")
    j64 = JGeneralOperators(jm, jbuild_dofmap(jm, p), dtype=jnp.float64, rule="gauss")
    mesh, _ = convert.general_mesh_from_numpy(jm.points, jm.cells)
    t16 = GeneralOperators(mesh, build_dofmap(mesh, p), dtype=BF16, rule="gauss")
    b = np.random.default_rng(0).standard_normal(t16.ndofs)
    b = np.asarray(jnp.asarray(b, jnp.bfloat16)).astype(np.float64)
    return j16.mass_indexed, j64.mass_indexed, t16.mass, b


@pytest.mark.parametrize("system", ["bp1", "general"])
def test_cg_within_the_jax_yardstick(system):
    """CG in bf16 (float32 dots, alpha and beta) on BP1's mass (kernel G's
    twin) and on the general Gauss mass (kernel K's mass_gauss twin), kmax
    20: the solution's error against the f64 CG after the same kmax is at
    most RATIO x the JAX package's bf16 CG's; neither reaches rtol 1e-4."""
    j16, j64, t16, b = _bp1_systems() if system == "bp1" else _general_mass_systems()
    kmax, rtol = 20, 1e-4
    x64, _, _ = jax.jit(lambda v: jcg(j64, v, kmax=kmax, rtol=rtol))(jnp.asarray(b))
    xj, kj, _ = jax.jit(lambda v: jcg(j16, v, kmax=kmax, rtol=rtol))(
        jnp.asarray(b, jnp.bfloat16))
    x, k, rnorm = cg(t16, torch.as_tensor(b).to(BF16), kmax=kmax, rtol=rtol)
    assert x.dtype == BF16 and rnorm.dtype == torch.float32 and k == kmax
    assert _l2(x, x64) <= RATIO * _l2(xj, x64), (_l2(x, x64), _l2(xj, x64), int(kj))


# -- the benchmarks' --dtype bf16 ------------------------------------------------
@pytest.mark.parametrize("op", operators_bench.STRUCTURED_OPS + operators_bench.GENERAL_OPS)
def test_operators_bench_runs_bf16_with_check(op):
    rec = operators_bench.run(op=op, size=3, degree=2, reps=2, check=True, dtype="bf16",
                              device="cpu")
    assert rec["dtype"] == "bf16"
    assert rec["max_rel_err_vs_f64_oracle"] <= common.BF16_CHECK_TOL


@pytest.mark.parametrize("op,precond", [("bp1", False), ("bp1", True), ("spectral", False),
                                        ("general", False), ("general", True)])
def test_cg_bench_runs_bf16(op, precond):
    """One device: CG runs to kmax in bf16, and the record has the f64 CG's
    iterations and the solution's error against it."""
    rec = cg_bench.run(op=op, size=3, degree=2, reps=2, dtype="bf16", device="cpu",
                       precond=precond, kmax=20)
    assert rec["dtype"] == "bf16" and 0 < rec["iters"] <= 20
    assert 0 < rec["sol_rel_vs_f64"] < 0.1 and rec["iters_f64"] <= 20


@pytest.mark.parametrize("op", ["spectral", "general"])
def test_cg_bench_ndev_runs_bf16(op):
    """--ndev 2 in bf16, held against one device by the bench's own check
    (iterations within 1; solutions within 10 rtol (spectral) or 1e-2
    (general), the JAX bench's rules)."""
    rec = cg_bench.run(op=op, size=4, degree=2, reps=2, dtype="bf16", device="cpu", ndev=2)
    assert rec["ndev"] == 2 and abs(rec["iters"] - rec["iters_single_device"]) <= 1


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_general_solve_runs_bf16(integrator):
    rec = general_solve.run(size=3, degree=2, steps=6, reps=2, dtype="bf16", device="cpu",
                            integrator=integrator)
    assert rec["dtype"] == "bf16" and rec["vmax"] > 0


@pytest.mark.parametrize("mode", scatter_bench.MODES)
def test_scatter_bench_runs_bf16(mode):
    rec = scatter_bench.run(mode=mode, size=4, degree=2, reps=2, dtype="bf16", device="cpu",
                            check=True, ndev=2)
    assert rec["dtype"] == "bf16"


def test_tsmm_runs_bf16_with_check():
    rec = tsmm.run(ncells=20, degree=2, reps=2, dtype="bf16", device="cpu", check=True)
    assert rec["dtype"] == "bf16" and rec["max_rel_err_vs_f64"] <= common.BF16_CHECK_TOL


def test_bench_check_raises_above_the_bf16_limit():
    common.check_bf16("f32", 1.0, "f32 records carry no limit")
    common.check_bf16("bf16", common.BF16_CHECK_TOL, "at the limit")
    with pytest.raises(RuntimeError, match="bf16 error"):
        common.check_bf16("bf16", 2 * common.BF16_CHECK_TOL, "above it")
    with pytest.raises(ValueError, match="f16"):
        common.bench_dtype("f16")


# -- the growth script on the general model ------------------------------------
def test_growth_script_runs_the_general_model_on_the_cpu():
    """apps/bf16_growth.py --general: the imported-mesh model's four runs
    on a small perturbed box, and lam0 of its bf16 K stiffness."""
    rec = bf16_growth.run(cells=(4, 2, 2), steps=20, every=10, fit=10, device="cpu",
                          general=True)
    assert set(rec["runs"]) == set(bf16_growth.RUNS) and rec["model"] == "general"
    assert all([s for s, _ in series] == [10, 20] for series in rec["runs"].values())
    assert set(rec["lam0"]) == {"bf16 tables", "f32 tables"}
    assert all(np.isfinite(v) for v in rec["lam0"].values())


@pytest.mark.parametrize("ndev", [1, 2])
def test_app_runs_bf16_on_an_imported_mesh(tmp_path, caplog, ndev):
    """The app's --mesh --dtype bf16 (one device, and --ndev 2: RCB parts)
    on the CPU: the bf16 state, finite, the source on, and the bf16 note,
    not the box's growth warning (K's stiffness does not grow)."""
    import logging

    from wave_fenics_tpu_torch.apps import planar3d_app
    from wave_fenics_tpu_torch.core.io import write_xdmf_mesh, write_xdmf_meshtags

    hm, tags = general_solve.perturbed_box((4, 2, 2), h=0.002)
    write_xdmf_mesh(str(tmp_path / "mesh.xdmf"), hm)
    write_xdmf_meshtags(str(tmp_path / "tags.xdmf"), hm, np.concatenate([tags[1], tags[2]]),
                        [1] * len(tags[1]) + [2] * len(tags[2]))
    cfg, kw = planar3d_app.parse_args(
        ["--mesh", str(tmp_path / "mesh.xdmf"), "--meshtags", str(tmp_path / "tags.xdmf"),
         "--degree", "2", "--dtype", "bf16", "--device", "cpu", "--steps", "6",
         "--ndev", str(ndev)])
    with caplog.at_level(logging.WARNING):
        rec, u, v = planar3d_app.run(cfg, **kw, return_state=True)
    assert rec["dtype"] == "bf16" and rec["ndev"] == ndev and rec["u_max"] > 0
    assert planar3d_app.BF16_NOTE in caplog.text
    assert planar3d_app.BF16_WARNING not in caplog.text
    held = u if ndev == 1 else u[0]
    assert held.dtype == BF16 and bool(torch.isfinite(held.float()).all())
