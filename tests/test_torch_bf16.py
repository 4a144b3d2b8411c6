"""bf16 state on the box's RK4 path (kernels A, C, B, D and F) against the
JAX package on the CPU.

The JAX side runs in bf16 as its own tests run it (Pallas kernels in
interpret mode off the TPU, ``jax.jit``); the port runs its plain bf16
twins (bf16 storage, float32 arithmetic, one rounding where a kernel
stores). The oracles are JAX's f64 answer, its bf16 ``solve_n`` and its
kernels called one step at a time with g computed in f64: JAX's fused bf16
solvers carry t in bf16, so their source never switches on (the strict
xfail below records it).

Tolerances: one step, stage or apply within 1e-2 of max|ref| (about two
bf16 ulps: the two packages round at other places); a 50-step solve's
relative L2 error against JAX's f64 answer within 1.5x that of JAX's own
bf16 solve of the same scheme (``solve_n`` for the padded paths, the
unpadded ``LinearWave.solve`` for the port's: its eager bf16 RK4 updates
lose more than the padded paths, in both packages).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import EXTENT, X_FACES
from wave_fenics_tpu.core.mesh import FacetTags as JFacetTags
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.models.linear_wave import LinearWave as JLinearWave
from wave_fenics_tpu.models.linear_wave_padded import PaddedLinearWave as JPadded
from wave_fenics_tpu.models.linear_wave_padded import _x_face_planes as j_x_face_planes
from wave_fenics_tpu.ops import pallas_rk4step as jstep
from wave_fenics_tpu.ops import pallas_stiffness as jps
from wave_fenics_tpu.ops import pallas_wave as jwave
from wave_fenics_tpu.ops.separable import grid_lines as j_grid_lines
from wave_fenics_tpu.ops.separable import separable_stiffness_tables as j_sep_tables
from wave_fenics_tpu.utils.config import SimulationConfig as JConfig
from wave_fenics_tpu_torch import convert
from wave_fenics_tpu_torch.apps import planar3d_app
from wave_fenics_tpu_torch.benchmarks import common, operators_bench
from wave_fenics_tpu_torch.core.io import read_xdmf_attributes
from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave
from wave_fenics_tpu_torch.models.linear_wave import LinearWave
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.ops import rk4step, stiffness, wave
from wave_fenics_tpu_torch.ops.wave import FlatTables
from wave_fenics_tpu_torch.ops.separable import grid_lines, separable_stiffness_tables
from wave_fenics_tpu_torch.parallel.partition import decompose3d
from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave
from wave_fenics_tpu_torch.utils.checkpoint import load_state, save_state
from wave_fenics_tpu_torch.utils.config import SimulationConfig

BF16 = torch.bfloat16
DT = 1e-9
NSTEPS = 50
ONE = 1e-2  # one step, stage or apply: max|err| / max|ref|
RATIO = 1.5  # a solve's error against f64: at most 1.5x the JAX yardstick's
GS = (1.0e5, 0.7e5, 0.4e5, 0.1e5)  # distinct per-stage sources (f64)


def _bits(a) -> np.ndarray:
    """A JAX bf16 array, or a port bf16 tensor, as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return convert.to_numpy_bits(a)
    return np.asarray(a).view(np.uint16)


def _jax_padded(dtype, p=4, tile_x=16):
    mesh = jbox_mesh((4, 2, 2), EXTENT, facet_tags=JFacetTags(X_FACES))
    return JPadded(JLinearWave(mesh, p=p, dtype=dtype), tile_x=tile_x)


def _port_padded(dtype, p=4, lean=True):
    mesh = box_mesh((4, 2, 2), EXTENT, facet_tags=FacetTags(X_FACES))
    return PaddedLinearWave(LinearWave(mesh, p=p, dtype=dtype, device="cpu"),
                            tile_x=16, lean=lean)


def _l2(got, ref) -> float:
    got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _rel(got, want) -> float:
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float64)
    want = want.double().numpy() if isinstance(want, torch.Tensor) else np.asarray(
        want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_bf16(layout, seed, scale=1.0):
    """A random JAX bf16 state on ``layout``'s interior, zero padding."""
    x = np.zeros(layout.padded_shape)
    x[layout.interior] = scale * np.random.default_rng(seed).standard_normal(layout.shape)
    return jnp.asarray(x, dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def f64_answer():
    """JAX's f64 solve_n over NSTEPS steps from zero (padded; and the grid)."""
    jpm = _jax_padded(jnp.float64)
    u, v = jpm.solve_n(0.0, DT, NSTEPS)
    return np.asarray(u), np.asarray(v)


@pytest.fixture(scope="module")
def yardstick(f64_answer):
    """The relative L2 errors of JAX's bf16 solve_n against its f64 answer
    (about u 1.27e-2, v 5.74e-3)."""
    ju, jv = _jax_padded(jnp.bfloat16).solve_n(0.0, DT, NSTEPS)
    return _l2(ju, f64_answer[0]), _l2(jv, f64_answer[1])


@pytest.fixture(autouse=True)
def _x64():
    """The f64 answers need JAX's x64 mode (the package's tests run in it)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


# -- tables and conversion -----------------------------------------------------
def test_padded_tables_bit_for_bit():
    """The port's bf16 step, flat and stencil tables, the facet planes and
    the separable tables are the JAX package's bf16 tables bit for bit."""
    jpm, pm = _jax_padded(jnp.bfloat16), _port_padded(BF16)
    jb = jpm.base
    jA, _ = j_sep_tables(jb.p, jb.mesh.h, jb.dtype)
    jlines = j_grid_lines(jb.mesh.shape, jb.p, jb.dtype)
    A, _ = separable_stiffness_tables(4, pm.base.mesh.h, BF16)
    lines = grid_lines(pm.base.mesh.shape, 4, BF16)
    for got, want in zip(A + lines, jA + jlines):
        np.testing.assert_array_equal(_bits(torch.as_tensor(got).to(BF16)), _bits(want))
    w1, w2, src_x, abc_x = j_x_face_planes(jpm)
    coeff = -float(jb.c0) ** 2
    jstep_tabs = jstep.build_step_tables(jpm.layout, jA, jlines, coeff, jpm._m_lines,
                                         w1, w2, src_x, abc_x, dtype=jb.dtype)
    for got, want in zip(pm.step_tables, jstep_tabs):
        assert got.dtype == BF16
        np.testing.assert_array_equal(_bits(got), _bits(want))
    jflat = jwave.build_tables_flat(jpm.layout, jA, jlines, coeff,
                                    inv_m_lines=jpm._m_lines, dtype=jb.dtype)
    for got, want in zip(pm.flat_tables, jflat):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # the kernels' stencil folds the lines as the step tables do
    st, tb = pm.stencil, pm.step_tables
    np.testing.assert_array_equal(_bits(st.cvy), _bits(tb.CVY))
    np.testing.assert_array_equal(_bits(st.cvz), _bits(tb.CVZ))
    np.testing.assert_array_equal(_bits(st.fx), _bits(tb.FX.reshape(-1)))
    np.testing.assert_array_equal(_bits(pm.face_w1), _bits(w1.reshape(1, -1)))
    np.testing.assert_array_equal(_bits(pm.face_w2), _bits(w2.reshape(1, -1)))


def test_linear_wave_buffers_bit_for_bit():
    """LinearWave's inv_m, W1 and W2 in bf16 are the JAX model's."""
    jm = _jax_padded(jnp.bfloat16).base
    m = _port_padded(BF16).base
    for got, want in ((m.inv_m, jm.inv_m), (m.W1, jm.W1), (m.W2, jm.W2)):
        assert got.dtype == BF16
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_state_crosses_bit_for_bit():
    """A JAX bf16 state goes to torch (convert.state_from_numpy) and back
    (convert.to_numpy_bits) bit for bit; numpy_dtype keeps refusing bf16."""
    jpm = _jax_padded(jnp.bfloat16)
    ju, jv = _random_bf16(jpm.layout, 1), _random_bf16(jpm.layout, 2, 1e3)
    u, v = convert.state_from_numpy(np.asarray(ju), np.asarray(jv), "cpu",
                                    np.asarray(ju).dtype)
    assert u.dtype == v.dtype == BF16
    np.testing.assert_array_equal(convert.to_numpy_bits(u), _bits(ju))
    np.testing.assert_array_equal(convert.to_numpy_bits(v), _bits(jv))
    assert convert.torch_dtype(jnp.bfloat16) == BF16
    with pytest.raises(ValueError):
        convert.numpy_dtype(BF16)


# -- one step, stage or apply against JAX's kernels ----------------------------
@pytest.mark.parametrize("lean", [True, False], ids=["A", "C"])
def test_one_step_matches_jax_kernel(lean):
    """One step of JAX's step kernel (lean: A; full tableau: C) from a
    random bf16 state, g per stage computed in f64, against the port's
    plain step."""
    jpm, pm = _jax_padded(jnp.bfloat16), _port_padded(BF16, lean=lean)
    jb = jpm.base
    w1, w2, src_x, abc_x = j_x_face_planes(jpm)
    jA, _ = j_sep_tables(jb.p, jb.mesh.h, jb.dtype)
    jlines = j_grid_lines(jb.mesh.shape, jb.p, jb.dtype)
    tabs = jstep.build_step_tables(jpm.layout, jA, jlines, -float(jb.c0) ** 2,
                                   jpm._m_lines, w1, w2, src_x, abc_x, dtype=jb.dtype)
    step = jax.jit(jstep.make_rk4_step(jpm.layout, tabs, jb.c0, dtype=jb.dtype,
                                       lean=lean))
    ju0, jv0 = _random_bf16(jpm.layout, 3), _random_bf16(jpm.layout, 4, 1e3)
    ju, jv = step(ju0, jv0, DT, *GS)
    u0, v0 = convert.state_from_numpy(np.asarray(ju0), np.asarray(jv0), "cpu", BF16)
    plain = rk4step.rk4_step_lean_plain if lean else rk4step.rk4_step_full_plain
    u, v = plain(u0, v0, DT, GS, pm.layout, pm.base.c0, pm.step_tables)
    assert u.dtype == v.dtype == BF16
    assert _rel(u, ju) <= ONE and _rel(v, jv) <= ONE


def test_one_stage_matches_jax_kernel_d():
    """One stage of JAX's fused stage kernel (D) from random bf16 fields
    against the port's rk_stage_plain: all four outputs."""
    jpm, pm = _jax_padded(jnp.bfloat16), _port_padded(BF16)
    ins = [_random_bf16(jpm.layout, 10 + i, 1e3 if i % 2 else 1.0) for i in range(6)]
    ca, cb, g = 0.5 * DT, DT / 3.0, 2.0e4
    want = jax.jit(jpm._stage_fn)(*ins, ca, cb, g)
    tins = [convert.tables_from_numpy((np.asarray(x),), "cpu", BF16)[0] for x in ins]
    got = wave.rk_stage_plain(*tins, ca, cb, g, pm.layout, pm.base.c0, pm.flat_tables,
                              pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
    for gt, wt in zip(got, want):
        assert gt.dtype == BF16
        assert _rel(gt, wt) <= ONE


def test_one_apply_matches_jax_kernel_b():
    """One apply of JAX's flat kernel (B) against apply_flat_plain and the
    kernels' own sum order (apply_stencil_plain), from a random bf16 state."""
    jpm, pm = _jax_padded(jnp.bfloat16), _port_padded(BF16)
    jx = _random_bf16(jpm.layout, 5)
    want = jpm._apply(jx)
    x = convert.tables_from_numpy((np.asarray(jx),), "cpu", BF16)[0]
    for got in (wave.apply_flat_plain(x, pm.layout, pm.flat_tables),
                wave.apply_stencil_plain(x, pm.layout, pm.stencil)):
        assert got.dtype == BF16
        assert _rel(got, want) <= ONE


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's fused stiffness kernel in Pallas interpret mode."""
    orig = jps.pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(jps.pl, "pallas_call", patched)


def test_one_apply_matches_jax_kernel_f(interpret):
    """One apply of JAX's fused stiffness (kernel F) in bf16 against
    stiffness_grid_plain on the port's bf16 tables."""
    jm, m = _jax_padded(jnp.bfloat16).base, _port_padded(BF16).base
    x = np.random.default_rng(6).standard_normal(m.ops.grid_shape)
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    coeff = -(1500.0**2)
    want = jps.stiffness_fused(jx, jm.ops._sepA, jm.ops._seplines, 4, coeff)
    tabs = stiffness.GridStiffnessTables(*convert.tables_from_numpy(
        stiffness.stiffness_grid_tables(m.ops._sepA, m.ops._seplines, m.ops.grid_shape,
                                        4, coeff, BF16), "cpu", BF16))
    x16 = convert.tables_from_numpy((np.asarray(jx),), "cpu", BF16)[0]
    got = stiffness.stiffness_grid_plain(x16, tabs, 4)
    assert got.dtype == BF16
    assert _rel(got, want) <= ONE
    # StructuredOperators' CPU stiffness (the separable twin) agrees
    assert _rel(m.ops.stiffness(x16, 1500.0), want) <= ONE


# -- 50-step solves against JAX's f64 answer -----------------------------------
@pytest.mark.parametrize("path", ["solve_step_n", "solve_step_n full", "solve_fused_n",
                                  "solve_n"])
def test_padded_solves_within_the_jax_yardstick(path, f64_answer, yardstick):
    """Each padded bf16 path's 50-step error against JAX's f64 answer is at
    most 1.5x that of JAX's bf16 solve_n (relative L2, u and v)."""
    name, *full = path.split()
    pm = _port_padded(BF16, lean=not full)
    out = getattr(pm, name)(0.0, DT, NSTEPS)
    u, v = out[0], out[1]
    assert u.dtype == v.dtype == BF16
    eu, ev = _l2(u, f64_answer[0]), _l2(v, f64_answer[1])
    assert eu <= RATIO * yardstick[0] and ev <= RATIO * yardstick[1], (eu, ev, yardstick)


def test_linear_wave_solve_within_the_jax_yardstick():
    """LinearWave.solve in bf16 (F's plain twin in f1): its error against
    JAX's f64 answer at most 1.5x that of JAX's own bf16 LinearWave.solve
    (u 1.10e-2, v 9.40e-3; the port: u 6.09e-3, v 9.40e-3). Against JAX's
    bf16 solve_n's v (5.74e-3) it would not hold: the unpadded model's
    eager bf16 updates (f1's five operations, the stages' axpys) round more
    often than the padded paths', in both packages."""
    mesh = jbox_mesh((4, 2, 2), EXTENT, facet_tags=JFacetTags(X_FACES))
    ju, jv, _ = JLinearWave(mesh, p=4, dtype=jnp.float64).solve(0.0, NSTEPS * DT, DT)
    bu, bv, _ = JLinearWave(mesh, p=4, dtype=jnp.bfloat16).solve(0.0, NSTEPS * DT, DT)
    m = _port_padded(BF16).base
    u, v, n = m.solve(0.0, NSTEPS * DT, DT)
    assert u.dtype == BF16 and n == NSTEPS
    ju, jv = np.asarray(ju), np.asarray(jv)
    assert _l2(u, ju) <= RATIO * _l2(bu, ju) and _l2(v, jv) <= RATIO * _l2(bv, jv)


@pytest.mark.xfail(strict=True, reason=(
    "a fault of the reference: JAX's bf16 fused solvers carry t in the state "
    "dtype (models/linear_wave_padded.py:379, and :462, :548, :649 for solve_lf_n, "
    "solve_lf2_n, solve_step2_n: jnp.asarray(t0, dtype=u0.dtype)), so the window "
    "0.5 (1 - cos(...)) of a bf16 t rounds to 0, the source never switches on and "
    "v stays 0; pallas_rk4step.py:554 also rounds dt and g to bf16"))
@pytest.mark.parametrize("path", ["solve_step_n", "solve_fused_n", "solve_lf_n",
                                  "solve_lf2_n", "solve_step2_n"])
def test_jax_bf16_fused_paths_match_its_solve_n(path):
    """Each fused bf16 solver of the JAX package against its own bf16
    reference of the same scheme: solve_n for the RK4 paths (on a tile of
    the 6p halo for solve_step2_n), leapfrog_solve_n on its force for the
    leapfrog paths."""
    from wave_fenics_tpu.solvers.leapfrog import leapfrog_solve_n as j_leapfrog_solve_n

    jpm = _jax_padded(jnp.bfloat16, tile_x=24 if path == "solve_step2_n" else 16)
    if path.startswith("solve_lf"):
        ru, rv = jax.jit(lambda u, v: j_leapfrog_solve_n(
            jpm.force, jpm.damping, u, v, 0.0, DT, NSTEPS))(*jpm.zero_state())
    else:
        ru, rv = jpm.solve_n(0.0, DT, NSTEPS)
    u, v, _ = getattr(jpm, path)(0.0, DT, NSTEPS)
    assert _l2(u, ru) <= 0.1 and _l2(v, rv) <= 0.1


# -- growth over long runs: the reference's, and its cause -------------------
GROWTH_CELLS = (8, 4, 4)  # the planar3d case at p = 4, cells cubic
GROWTH_STEPS = 612  # three times its 204-step solve
GROWTH = 3.0  # the bf16 runs end above GROWTH x the f32 run's max|u|


def test_bf16_solve_n_grows_as_the_jax_package_does():
    """A bf16 run of the box's RK4 scheme grows from some hundreds of steps
    on, in the JAX package as in the port, and the bf16 tables are the
    cause. On the planar3d case at (8, 4, 4) cells, p = 4, over 612 steps:
    JAX's bf16 solve_n and the port's (kernel B's plain twin in f1) end
    above 3x the f32 run's max|u| over those steps (7.0x and 5.4x here);
    the port's with the f32 model's flat tables, the state still bf16,
    stays within 1.5x of it (0.78x). The growth rate per step is the same at any
    cell size (dt and the tables' row sums scale with h and 1/h^2), so
    the P1 width grows from the same step count."""
    from wave_fenics_tpu.models.planar3d import planar3d_case as j_planar3d_case

    _, p32 = planar3d_app.build(cells=GROWTH_CELLS, dtype="f32", device="cpu", tile_x=16)
    case, p16 = planar3d_app.build(cells=GROWTH_CELLS, dtype="bf16", device="cpu",
                                   tile_x=16)
    dt, chunk = case.dt, GROWTH_STEPS // 12
    u, v = p32.zero_state()
    m32 = 0.0
    for i in range(12):
        u, v = p32.solve_n(i * chunk * dt, dt, chunk, u, v)[:2]
        m32 = max(m32, float(u.abs().max()))
    jcase = j_planar3d_case(ncells=GROWTH_CELLS, degree=4, dtype=jnp.bfloat16)
    assert jcase.dt == dt
    ju, _ = JPadded(jcase.model, tile_x=16).solve_n(0.0, dt, GROWTH_STEPS)
    u16 = p16.solve_n(0.0, dt, GROWTH_STEPS)[0]
    for name in FlatTables._fields:  # the control: f32 tables, bf16 state
        setattr(p16, f"flat_{name}", getattr(p32, f"flat_{name}"))
    uc = p16.solve_n(0.0, dt, GROWTH_STEPS)[0]
    assert uc.dtype == u16.dtype == BF16
    ratios = [float(np.abs(np.asarray(ju, np.float32)).max()) / m32,
              float(u16.float().abs().max()) / m32, float(uc.float().abs().max()) / m32]
    assert ratios[0] > GROWTH and ratios[1] > GROWTH and ratios[2] <= 1.5, ratios


def test_growth_script_runs_on_the_cpu():
    """apps/bf16_growth.py on a CPU device at (4, 2, 2) cells: its four
    runs, and lam0 of the bf16 tables positive and far above the f32
    tables' (the same per h^2 at every size: 6.19e4 at p = 4)."""
    from wave_fenics_tpu_torch.apps import bf16_growth

    rec = bf16_growth.run(cells=(4, 2, 2), steps=20, every=10, fit=10, device="cpu")
    assert set(rec["runs"]) == set(bf16_growth.RUNS)
    assert all([s for s, _ in series] == [10, 20] for series in rec["runs"].values())
    h = 0.1 / 4
    assert rec["lam0"]["bf16 tables"] * h * h == pytest.approx(6.1887e4, rel=1e-3)
    assert abs(rec["lam0"]["f32 tables"]) < 1e-3 * rec["lam0"]["bf16 tables"]
    assert all(r is not None for r in rec["fitted_rate"].values())


# -- configuration, guards, snapshots and the app ---------------------------
def test_bf16_config_builds_the_jax_case():
    """A bf16 SimulationConfig builds JAX's dt, nsteps and dofs."""
    jc, c = JConfig(), SimulationConfig()
    for cfg in (jc, c):
        cfg.domain.ncells = (4, 2, 2)
        cfg.run.dtype = "bf16"
    jcase, case = jc.build_case(), c.build_case(device="cpu")
    assert (case.dt, case.nsteps, case.steps_per_period) == (
        jcase.dt, jcase.nsteps, jcase.steps_per_period)
    assert case.model.ops.ndofs == jcase.model.ops.ndofs
    assert case.model.dtype == BF16


def _write_mesh(tmp_path) -> str:
    """A perturbed (4, 2, 2)-cell box and its x-face tags as XDMF files
    with HDF5 heavy data (the form both packages read) under ``tmp_path``;
    returns the mesh's path (tags.xdmf beside it)."""
    from wave_fenics_tpu_torch.benchmarks.general_solve import perturbed_box
    from wave_fenics_tpu_torch.core.io import write_xdmf_mesh, write_xdmf_meshtags

    hm, tags = perturbed_box((4, 2, 2), h=0.002)
    write_xdmf_mesh(str(tmp_path / "mesh.xdmf"), hm, data_format="hdf")
    write_xdmf_meshtags(str(tmp_path / "tags.xdmf"), hm,
                        np.concatenate([tags[1], tags[2]]),
                        [1] * len(tags[1]) + [2] * len(tags[2]), data_format="hdf")
    return str(tmp_path / "mesh.xdmf")


@pytest.mark.parametrize("fields", [
    {"domain__mesh_path": "mesh"},
    {"run__ndev": 2},
    {"domain__mesh_path": "mesh", "run__ndev": 2},
], ids=["mesh", "ndev2", "mesh ndev2"])
def test_bf16_configs_of_mesh_and_ndev_build_the_jax_case(fields, tmp_path):
    """A bf16 SimulationConfig with an imported mesh (kernel K) or with
    run.ndev = 2 (the sharded paths) builds JAX's dt, nsteps and dofs, as
    the one-device box's does (these raised before K and the sharded paths
    took bf16)."""
    mesh = _write_mesh(tmp_path)
    jc, c = JConfig(), SimulationConfig()
    for cfg in (jc, c):
        cfg.domain.ncells = (4, 2, 2)
        cfg.run.dtype = "bf16"
        for key, value in fields.items():
            section, name = key.split("__")
            setattr(getattr(cfg, section), name, mesh if value == "mesh" else value)
        if cfg.domain.mesh_path is not None:
            cfg.domain.meshtags_path = str(tmp_path / "tags.xdmf")
            cfg.domain.degree = 2
    jcase, case = jc.build_case(), c.build_case(device="cpu")
    assert (case.dt, case.nsteps, case.steps_per_period) == (
        jcase.dt, jcase.nsteps, jcase.steps_per_period)
    assert case.model.ops.ndofs == jcase.model.ops.ndofs
    assert case.model.dtype == BF16


@pytest.mark.parametrize("fields", [
    {"time__integrator": "leapfrog"},
    {"domain__degree": 10, "domain__ncells": (3, 2, 2)},
], ids=["leapfrog", "p10"])
def test_bf16_configs_of_h_i_and_e_build_the_jax_case(fields):
    """A bf16 SimulationConfig with leapfrog (kernels H, I) or p = 10
    (kernel E) builds JAX's dt, nsteps and dofs, as the RK4 box's does."""
    jc, c = JConfig(), SimulationConfig()
    for cfg in (jc, c):
        cfg.domain.ncells = (4, 2, 2)
        cfg.run.dtype = "bf16"
        for key, value in fields.items():
            section, name = key.split("__")
            setattr(getattr(cfg, section), name, value)
    jcase, case = jc.build_case(), c.build_case(device="cpu")
    assert (case.dt, case.nsteps, case.steps_per_period) == (
        jcase.dt, jcase.nsteps, jcase.steps_per_period)
    assert case.model.ops.ndofs == jcase.model.ops.ndofs
    assert case.model.dtype == BF16 and case.model.p == c.domain.degree


@pytest.mark.parametrize("path", ["blocks", "imported mesh", "bp1 mass", "bench dtype",
                                  "operators_bench"])
def test_bf16_paths_that_raised_run(path):
    """Every bf16 path that raised before this port's G, K and sharded
    paths took bf16 builds and runs: blocks, an imported mesh (K), BP1's
    mass (G) and the benchmarks."""
    pm = _port_padded(BF16)
    if path == "blocks":
        u, v, _ = ShardedPaddedWave(pm.base, decompose3d(2)).solve_n(0.0, DT, 2)
        out = v[0]
    elif path == "imported mesh":
        hm = box_mesh((3, 2, 2), EXTENT, facet_tags=FacetTags(X_FACES)).to_hex_mesh()
        m = GeneralLinearWave(hm, 2, {}, dtype=BF16, device="cpu")
        out = m.f1(1e-7, *m.zero_state()) + m.ops.stiffness(m.zero_state()[0] + 1, m.c0)
    elif path == "bp1 mass":
        x = torch.ones(pm.base.ops.grid_shape, dtype=BF16)
        out = pm.base.ops.mass_gauss(x)
        assert float(out.float().sum()) > 0
    elif path == "bench dtype":
        assert common.bench_dtype("bf16") == BF16
        out = torch.zeros(1, dtype=common.bench_dtype("bf16"))
    else:
        rec = operators_bench.run(op="stiffness", size=4, degree=2, dtype="bf16",
                                  device="cpu", check=True)
        assert rec["dtype"] == "bf16"
        out = torch.tensor([rec["max_rel_err_vs_f64_oracle"]]).to(BF16)
    assert out.dtype == BF16 and bool(torch.isfinite(out.float()).all())


def test_bf16_snapshot_resumes_bit_for_bit(tmp_path):
    """save_state/load_state keep a bf16 state's bits; the app resumes a
    bf16 run from its snapshot and ends where one unchunked run ends."""
    u = torch.randn(5, 6).to(BF16)
    save_state(str(tmp_path / "s"), u, -u, 1.5, {"k": 1})
    lu, lv, t, meta = load_state(str(tmp_path / "s"))
    assert lu.dtype == BF16 and torch.equal(lu, u) and torch.equal(lv, -u)
    assert t == 1.5 and meta == {"k": 1}

    cfg = SimulationConfig()
    cfg.domain.ncells = (4, 2, 2)
    cfg.run.dtype = "bf16"
    cfg.run.checkpoint_every_steps = 4
    kw = dict(device="cpu", steps=12, return_state=True)
    _, u_ref, v_ref = planar3d_app.run(cfg, checkpoint_dir=str(tmp_path / "a"), **kw)
    # a run cut after two chunks, then resumed from its snapshot at step 8
    planar3d_app.run(cfg, checkpoint_dir=str(tmp_path / "b"), device="cpu", steps=8)
    rec, u2, v2 = planar3d_app.run(cfg, checkpoint_dir=str(tmp_path / "b"), **kw)
    assert rec["resumed_from_step"] == 4 and rec["dtype"] == "bf16"
    assert torch.equal(u2, u_ref) and torch.equal(v2, v_ref)


def test_app_runs_bf16_on_the_cpu(tmp_path):
    """The app's --dtype bf16 on a (4,2,2)-cell case: the plain lean step,
    the dtype in its solver_path and its JSON; the XDMF output is the grid,
    widened exactly (the writer stores float64)."""
    out = tmp_path / "out.xdmf"
    cfg, kw = planar3d_app.parse_args(
        ["--cells", "4", "2", "2", "--dtype", "bf16", "--device", "cpu", "--steps", "6",
         "--output", str(out)])
    rec, u, v = planar3d_app.run(cfg, **kw, return_state=True)
    assert rec["dtype"] == "bf16" and "bf16" in rec["solver_path"]
    assert "lean RK4 step" in rec["solver_path"] and rec["nsteps"] == 6
    assert u.dtype == BF16 and bool(torch.isfinite(v.float()).all())
    assert float(v.float().abs().max()) > 0
    json.dumps(rec)
    _, pm = planar3d_app.build(cells=(4, 2, 2), degree=4, dtype="bf16", device="cpu")
    fields = read_xdmf_attributes(str(out))
    for name, x in (("u", u), ("v", v)):
        np.testing.assert_array_equal(fields[name].ravel(),
                                      pm.to_grid(x).double().numpy().ravel())
