"""bf16 state on the box's leapfrog, two-step and p > 8 paths (kernels H,
I, J and E) against the JAX package on the CPU.

The JAX side runs in bf16 as its own tests run it (Pallas kernels in
interpret mode off the TPU, ``jax.jit``, x64 on for the f64 answers); the
port runs its plain bf16 twins (bf16 storage, float32 arithmetic, one
rounding where a kernel stores). Inputs come from numpy seeds through
``convert.state_from_numpy`` and ``convert.tables_from_numpy``. JAX's
fused bf16 leapfrog and two-step solvers carry t in bf16 and never switch
the source on (``tests/test_torch_bf16.py``'s strict xfail records it), so
the oracles are JAX's f64 answers, its bf16 solvers on ``force`` and
``solve_n``, and its kernels called once with g computed in f64.

Tolerances (``tests/test_torch_bf16.py``'s): one call within 1e-2 of
max|ref| for each output (about two bf16 ulps: the two packages round at
other places); a 50-step solve's relative L2 error against JAX's f64
answer within 1.5x that of JAX's own bf16 solve of the same scheme, each
the largest over readings every 10 steps (below, at CHUNK).
"""

import logging
from pathlib import Path

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
from wave_fenics_tpu.ops import pallas_lf2step as jlf2
from wave_fenics_tpu.ops import pallas_lfstep as jlf
from wave_fenics_tpu.ops import pallas_rk42step as jrk42
from wave_fenics_tpu.ops import pallas_wave as jwave
from wave_fenics_tpu.ops.separable import grid_lines as j_grid_lines
from wave_fenics_tpu.ops.separable import separable_stiffness_tables as j_sep_tables
from wave_fenics_tpu.solvers.leapfrog import leapfrog_solve_n as j_leapfrog_solve_n
from wave_fenics_tpu_torch import convert
from wave_fenics_tpu_torch.apps import planar3d_app
from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu_torch.models.linear_wave import LinearWave
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.ops import _cuda, lf2step, lfstep, rk42step, wave
from wave_fenics_tpu_torch.solvers.leapfrog import leapfrog_solve_n

BF16 = torch.bfloat16
DT = 1e-9
NSTEPS = 50
ONE = 1e-2  # one call: max|err| / max|ref| of each output
RATIO = 1.5  # a solve's error against f64: at most 1.5x the JAX yardstick's
GS = (1.0e5, 0.7e5, 0.4e5, 0.1e5, -0.2e5)  # distinct sources at the call's times
P10_CELLS = (3, 2, 2)


def _bits(a) -> np.ndarray:
    """A JAX bf16 array, or a port bf16 tensor, as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return convert.to_numpy_bits(a)
    return np.asarray(a).view(np.uint16)


def _jax_padded(dtype, p=4, tile_x=16, cells=(4, 2, 2), kernel="flat"):
    mesh = jbox_mesh(cells, EXTENT, facet_tags=JFacetTags(X_FACES))
    return JPadded(JLinearWave(mesh, p=p, dtype=dtype), tile_x=tile_x, kernel=kernel)


def _port_padded(dtype, p=4, tile_x=16, cells=(4, 2, 2), kernel="flat"):
    mesh = box_mesh(cells, EXTENT, facet_tags=FacetTags(X_FACES))
    return PaddedLinearWave(LinearWave(mesh, p=p, dtype=dtype, device="cpu"),
                            tile_x=tile_x, kernel=kernel)


def _jax_table_args(jpm):
    """(A, lines, coeff, inv_m_lines, w1, w2, src_x, abc_x) of JAX's step
    table builders, in the model's dtype."""
    b = jpm.base
    w1, w2, src_x, abc_x = j_x_face_planes(jpm)
    A, _ = j_sep_tables(b.p, b.mesh.h, b.dtype)
    lines = j_grid_lines(b.mesh.shape, b.p, b.dtype)
    return A, lines, -float(b.c0) ** 2, jpm._m_lines, w1, w2, src_x, abc_x


def _l2(got, ref) -> float:
    got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _rel(got, want) -> float:
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_bf16(layout, seed, scale=1.0):
    """A random JAX bf16 state on ``layout``'s interior, zero padding."""
    x = np.zeros(layout.padded_shape)
    x[layout.interior] = scale * np.random.default_rng(seed).standard_normal(layout.shape)
    return jnp.asarray(x, dtype=jnp.bfloat16)


def _to_port(*xs):
    return convert.tables_from_numpy(tuple(np.asarray(x) for x in xs), "cpu", BF16)


@pytest.fixture(autouse=True)
def _x64():
    """The f64 answers need JAX's x64 mode (the package's tests run in it)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


# -- tables bit for bit --------------------------------------------------------
@pytest.mark.parametrize("p", [2, 4])
def test_lf_and_lf2_tables_bit_for_bit(p):
    """The bf16 lf and lf2 tables the model registers are the JAX
    builders' bf16 tables bit for bit."""
    jpm, pm = _jax_padded(jnp.bfloat16, p), _port_padded(BF16, p)
    args = _jax_table_args(jpm)
    for got, want in ((pm.lf_tables, jlf.build_lf_tables(jpm.layout, *args,
                                                          dtype=jnp.bfloat16)),
                      (pm.lf2_tables, jlf2.build_lf2_tables(jpm.layout, *args,
                                                            dtype=jnp.bfloat16))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == BF16
            np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("p", [2, 4])
def test_rk42_tables_bit_for_bit(p):
    """Kernel J reads the stencil tables and the facet planes: they are the
    JAX package's bf16 2-step tables bit for bit (CVY, CVZ, FX, W1, W2, the
    band windows' entries against cvx, SXS's rows against sx)."""
    jpm = _jax_padded(jnp.bfloat16, p, tile_x=rk42step._off0(p))
    pm = _port_padded(BF16, p, tile_x=rk42step._off0(p))
    assert pm.rk42_unavailable is None
    tabs = jrk42.build_rk42_tables(jpm.layout, *_jax_table_args(jpm), dtype=jnp.bfloat16)
    bands, (CVY, CVZ, FX, SXS, _, _, W1, W2) = tabs[:6], tabs[6:]
    st = pm.stencil
    for got, want in ((st.cvy, CVY), (st.cvz, CVZ), (st.fx, FX.reshape(-1)),
                      (pm.face_w1, W1), (pm.face_w2, W2)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    Tx, Lx = pm.layout.tile_x, pm.layout.padded_shape[0]
    off0 = rk42step._off0(p)
    cvx, sx = _bits(st.cvx), _bits(st.sx)
    sxs = _bits(SXS)
    for t in range(Lx // Tx):
        rows = [(r, t * Tx - off0 + r) for r in range(Tx + 2 * off0)]
        for r, g in rows:
            if 0 <= g < Lx:
                assert sxs[t, r, 0] == sx[g]
    for (o_w, nrows), W in zip(jrk42._window_shapes(p, Tx), bands):
        Wb = _bits(W)
        for t in range(1, Lx // Tx - 1):
            for r in range(nrows):
                g = t * Tx - off0 + o_w + r
                for k in range(2 * p + 1):
                    assert Wb[t, r, r + k] == cvx[k, g]


@pytest.mark.parametrize("p,cells,kernel", [(2, (4, 2, 2), "3d"), (4, (4, 2, 2), "3d"),
                                            (10, P10_CELLS, "flat")])
def test_slab_tables_bit_for_bit(p, cells, kernel):
    """The bf16 3D-slab tables (kernel E) are the JAX package's
    ``pallas_wave.build_tables`` in bf16 (tap form) bit for bit."""
    jpm = _jax_padded(jnp.bfloat16, p, cells=cells, kernel=kernel)
    pm = _port_padded(BF16, p, cells=cells, kernel=kernel)
    assert pm.kernel == "3d"
    A, lines, coeff, m_lines = _jax_table_args(jpm)[:4]
    want = jwave.build_tables(jpm.layout, A, lines, coeff, m_lines, dtype=jnp.bfloat16,
                              yz_matmul=False)
    for g, w in zip(pm.slab_tables, want):
        assert g.dtype == BF16
        np.testing.assert_array_equal(_bits(g), _bits(w))


# -- one call against JAX's kernels --------------------------------------------
@pytest.mark.parametrize("p", [3, 4])
def test_one_lf_step_matches_jax_kernel_h(p):
    """One call of JAX's leapfrog-step kernel (H) from a random bf16 state,
    g computed in f64, against the port's plain twin on its own tables."""
    jpm, pm = _jax_padded(jnp.bfloat16, p), _port_padded(BF16, p)
    c0 = pm.base.c0
    jt = jlf.build_lf_tables(jpm.layout, *_jax_table_args(jpm), dtype=jnp.bfloat16)
    step = jax.jit(jlf.make_lf_step_raw(jpm.layout, c0, dtype=jnp.bfloat16))
    ju0, jv0 = _random_bf16(jpm.layout, 3 + p), _random_bf16(jpm.layout, 4 + p, 1e3)
    ju, jv = step(ju0, jv0, DT, *GS[:2], *jt)
    u0, v0 = convert.state_from_numpy(np.asarray(ju0), np.asarray(jv0), "cpu", BF16)
    u, v = lfstep.lf_step_plain(u0, v0, DT, *GS[:2], pm.layout, c0, pm.lf_tables)
    assert u.dtype == v.dtype == BF16
    assert _rel(u, ju) <= ONE and _rel(v, jv) <= ONE


@pytest.mark.parametrize("p", [3, 4])
def test_one_lf2_call_matches_jax_kernel_i(p):
    """One call (two steps) of JAX's 2-step leapfrog kernel (I) from a
    random bf16 state against the port's plain twin."""
    jpm, pm = _jax_padded(jnp.bfloat16, p), _port_padded(BF16, p)
    c0 = pm.base.c0
    jt = jlf2.build_lf2_tables(jpm.layout, *_jax_table_args(jpm), dtype=jnp.bfloat16)
    step = jax.jit(jlf2.make_lf2_step_raw(jpm.layout, c0, dtype=jnp.bfloat16))
    ju0, jv0 = _random_bf16(jpm.layout, 5 + p), _random_bf16(jpm.layout, 6 + p, 1e3)
    ju, jv = step(ju0, jv0, DT, *GS[:3], *jt)
    u0, v0 = convert.state_from_numpy(np.asarray(ju0), np.asarray(jv0), "cpu", BF16)
    u, v = lf2step.lf2_step_plain(u0, v0, DT, *GS[:3], pm.layout, c0, pm.lf2_tables)
    assert u.dtype == v.dtype == BF16
    assert _rel(u, ju) <= ONE and _rel(v, jv) <= ONE


@pytest.mark.parametrize("p", [2, 4])
def test_one_rk42_call_matches_jax_kernel_j(p):
    """One call (two full-tableau RK4 steps) of JAX's 2-step kernel (J) on
    a tile of its 6p halo, from a random bf16 state, against the port's
    plain twin (its seven phases in float32, rounded where they store)."""
    tile = rk42step._off0(p)
    jpm, pm = _jax_padded(jnp.bfloat16, p, tile), _port_padded(BF16, p, tile)
    c0 = pm.base.c0
    jt = jrk42.build_rk42_tables(jpm.layout, *_jax_table_args(jpm), dtype=jnp.bfloat16)
    step2 = jax.jit(jrk42.make_rk42_step_raw(jpm.layout, c0, dtype=jnp.bfloat16))
    ju0, jv0 = _random_bf16(jpm.layout, 7 + p), _random_bf16(jpm.layout, 8 + p, 1e3)
    ju, jv = step2(ju0, jv0, DT, *GS, *jt)
    u0, v0 = convert.state_from_numpy(np.asarray(ju0), np.asarray(jv0), "cpu", BF16)
    u, v = rk42step.rk42_step_plain(u0, v0, DT, GS, pm.layout, c0, pm.stencil,
                                    pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
    assert u.dtype == v.dtype == BF16
    assert _rel(u, ju) <= ONE and _rel(v, jv) <= ONE


@pytest.mark.parametrize("p,cells,kernel", [(10, P10_CELLS, "flat"), (4, (4, 2, 2), "3d")])
def test_one_slab_apply_matches_jax_kernel_e(p, cells, kernel):
    """One apply of JAX's 3D-slab kernel (E) from a random bf16 state, in
    the band-matrix form its model runs, against apply_slab_plain; the
    padding exactly 0."""
    jpm = _jax_padded(jnp.bfloat16, p, cells=cells, kernel=kernel)
    pm = _port_padded(BF16, p, cells=cells, kernel=kernel)
    jx = _random_bf16(jpm.layout, 9 + p)
    want = jpm._apply(jx)
    (x,) = _to_port(jx)
    got = wave.apply_slab_plain(x, pm.layout, pm.slab_tables)
    assert got.dtype == BF16 and _rel(got, want) <= ONE
    outside = got.clone()
    outside[pm.layout.interior] = 0
    assert float(outside.abs().max()) == 0.0


# -- 50-step solves against JAX's f64 answer -----------------------------------
# The planar source makes a plane wave: u and v are nearly constant over
# each x row, so a state's bf16 error is a handful of rows, each rounded to
# one of its two bf16 neighbours, and the relative L2 error at one step
# swings between a few values (the leapfrog's u in JAX's bf16 run on its
# force: 1.06e-2 at step 30, 1.46e-3 at step 50; the port's paths take
# such values at other steps). So each solve is read every CHUNK steps and its
# error is the largest over those readings, in the port as in the
# yardstick.
CHUNK = 10


def _readings(advance, u, v, to_numpy=False):
    """(u, v) after each CHUNK steps of an NSTEPS-step solve from (u, v):
    ``advance(t0, u, v)`` runs CHUNK steps from time t0."""
    out = []
    for i in range(NSTEPS // CHUNK):
        u, v = advance(i * CHUNK * DT, u, v)
        out.append(tuple(np.asarray(x, np.float64) for x in (u, v)) if to_numpy
                   else (u, v))
    return out


def _worst(got, refs):
    """The largest relative L2 errors of u and of v over the readings."""
    return (max(_l2(g[0], r[0]) for g, r in zip(got, refs)),
            max(_l2(g[1], r[1]) for g, r in zip(got, refs)))


def _jax_answers(advance_of, model_of):
    """JAX's f64 readings and its bf16 yardstick (the worst errors of the
    same solve in bf16 against them)."""
    f64 = model_of(jnp.float64)
    refs = _readings(jax.jit(advance_of(f64)), *f64.zero_state(), to_numpy=True)
    b16 = model_of(jnp.bfloat16)
    return refs, _worst(_readings(jax.jit(advance_of(b16)), *b16.zero_state(),
                                  to_numpy=True), refs)


def _jax_leapfrog_chunk(jpm):
    return lambda t0, u, v: j_leapfrog_solve_n(jpm.force, jpm.damping, u, v, t0, DT,
                                               CHUNK)


def _jax_solve_n_chunk(jpm):
    return lambda t0, u, v: jpm.solve_n(t0, DT, CHUNK, u, v)


@pytest.fixture(scope="module")
def leapfrog_answers():
    """JAX's leapfrog on its padded force over NSTEPS steps from zero: the
    f64 readings, and the worst relative L2 errors of the same solve in
    bf16 against them (u, v)."""
    return _jax_answers(_jax_leapfrog_chunk, _jax_padded)


def _assert_within_yardstick(got, answers):
    refs, (yu, yv) = answers
    eu, ev = _worst(got, refs)
    assert eu <= RATIO * yu and ev <= RATIO * yv, (eu, ev, yu, yv)


@pytest.mark.parametrize("path", ["solve_lf_n", "solve_lf2_n", "force"])
def test_leapfrog_solves_within_the_jax_yardstick(path, leapfrog_answers):
    """The port's bf16 leapfrog paths (kernel H's and I's plain twins, and
    solvers/leapfrog.py on the padded force, kernel B's twin): each one's
    50-step error against JAX's f64 leapfrog at most 1.5x that of JAX's
    bf16 leapfrog on its force (relative L2, u and v, the worst reading)."""
    pm = _port_padded(BF16)
    if path == "force":
        def advance(t0, u, v):
            return leapfrog_solve_n(pm.force, pm.damping, u, v, t0, DT, CHUNK)
    else:
        def advance(t0, u, v):
            return getattr(pm, path)(t0, DT, CHUNK, u, v)[:2]
    got = _readings(advance, *pm.zero_state())
    assert all(x.dtype == BF16 for state in got for x in state)
    _assert_within_yardstick(got, leapfrog_answers)


def test_step2_solve_within_the_jax_yardstick():
    """solve_step2_n in bf16 (kernel J's plain twin, five calls a reading)
    against JAX's f64 solve_n: its error at most 1.5x that of JAX's bf16
    solve_n (tests/test_torch_bf16.py's yardstick, read every CHUNK steps),
    on a tile of the 6p halo."""
    tile = rk42step._off0(4)
    answers = _jax_answers(_jax_solve_n_chunk, lambda dt: _jax_padded(dt, tile_x=tile))
    pm = _port_padded(BF16, tile_x=tile)
    got = _readings(lambda t0, u, v: pm.solve_step2_n(t0, DT, CHUNK, u, v)[:2],
                    *pm.zero_state())
    assert got[-1][0].dtype == BF16
    _assert_within_yardstick(got, answers)


def test_p10_solve_n_within_the_jax_yardstick():
    """RK4 on f1 at p = 10 (kernel E's plain twin, eager bf16 vector
    algebra, as the JAX package's bf16 solve_n) on (3,2,2) cells: its
    error against JAX's f64 solve_n at most 1.5x that of JAX's bf16
    solve_n (relative L2, u and v, the worst reading)."""
    answers = _jax_answers(_jax_solve_n_chunk,
                           lambda dt: _jax_padded(dt, 10, cells=P10_CELLS))
    pm = _port_padded(BF16, 10, cells=P10_CELLS)
    assert pm.kernel == "3d"
    got = _readings(lambda t0, u, v: pm.solve_n(t0, DT, CHUNK, u, v), *pm.zero_state())
    assert got[-1][0].dtype == BF16
    _assert_within_yardstick(got, answers)


# -- the paths that raised in bf16 now run -------------------------------------
@pytest.mark.parametrize("path", ["solve_lf_n", "solve_lf2_n", "solve_step2_n", "p10",
                                  "3d"])
def test_bf16_paths_of_h_i_j_and_e_run(path):
    """The bf16 paths through H, I, J and E build and step (they raised
    before their kernels took bf16); the four kernels' sources instantiate
    their launchers in bf16."""
    for src in ("slab_tiled.cu", "lf_tiled.cu", "rk42_tiled.cu"):
        assert "(__nv_bfloat16, bf16)" in (Path(_cuda.CSRC) / src).read_text()
    if path.startswith("solve"):
        pm = _port_padded(BF16, tile_x=rk42step._off0(4))
        u, v, n = getattr(pm, path)(0.0, DT, 3)
    else:
        pm = (_port_padded(BF16, 10, cells=P10_CELLS) if path == "p10"
              else _port_padded(BF16, kernel="3d"))
        u, v = pm.solve_n(0.0, DT, 3)
    assert u.dtype == v.dtype == BF16 and bool(torch.isfinite(v.float()).all())
    assert float(v.float().abs().max()) > 0


# -- the app on the CPU --------------------------------------------------------
@pytest.mark.parametrize("case", ["leapfrog", "two-step", "p10 rk4", "p10 leapfrog"])
def test_app_runs_bf16_paths_on_the_cpu(case, caplog):
    """The app's --dtype bf16 on (4,2,2) cells ((3,2,2) at p = 10):
    leapfrog (kernel I's plain twin), --two-step (J's), and p = 10 with RK4
    and leapfrog (E's): finite, the plain path named with the bf16 state,
    the bf16 warning logged."""
    argv = ["--dtype", "bf16", "--device", "cpu", "--steps", "5"]
    if case.startswith("p10"):
        argv += ["--cells", *map(str, P10_CELLS), "--degree", "10"]
    else:
        argv += ["--cells", "4", "2", "2"]
    if "leapfrog" in case:
        argv += ["--integrator", "leapfrog"]
    if case == "two-step":
        argv += ["--two-step"]
    cfg, kw = planar3d_app.parse_args(argv)
    with caplog.at_level(logging.WARNING):
        rec, u, v = planar3d_app.run(cfg, **kw, return_state=True)
    want = {"leapfrog": "plain torch 2-step leapfrog", "two-step": "plain torch 2-step RK4",
            "p10 rk4": "plain torch RK4 on f1", "p10 leapfrog": "plain torch leapfrog on force"}
    assert rec["solver_path"].startswith(want[case]) and "bf16 state" in rec["solver_path"]
    assert rec["dtype"] == "bf16" and rec["nsteps"] == 5
    assert u.dtype == BF16 and bool(torch.isfinite(u.float()).all())
    assert bool(torch.isfinite(v.float()).all()) and float(v.float().abs().max()) > 0
    assert planar3d_app.BF16_WARNING in caplog.text


# -- the growth script: lam0 at every degree the box runs, and the leapfrog ---
@pytest.mark.parametrize("cells,p,lam0_h2", [
    ((4, 2, 2), 4, 6.1887e4), ((4, 2, 2), 8, 2.3838e5), ((3, 2, 2), 10, 2.1682e6),
    ((13, 7, 7), 10, -9.8157e6)])
def test_lam0_of_the_bf16_tables(cells, p, lam0_h2):
    """lam0 h^2 of the bf16 tables (apps/bf16_growth.py::lam0, the shift of
    the stencil's zero eigenvalue): positive at p = 4 and 8 (P1, P2, P14
    and P3 grow), at p = 10 of either sign by the cell count ((13,7,7), as
    P12's (26,13,13): negative, so the constant mode oscillates); the f32
    tables' far smaller."""
    from wave_fenics_tpu_torch.apps.bf16_growth import lam0

    _, p16 = planar3d_app.build(cells=cells, degree=p, dtype="bf16", device="cpu",
                                tile_x=16)
    _, p32 = planar3d_app.build(cells=cells, degree=p, dtype="f32", device="cpu",
                                tile_x=16)
    h = 0.1 / cells[0]
    got = lam0(p32, p16) * h * h
    assert got == pytest.approx(lam0_h2, rel=1e-4)
    assert abs(lam0(p32, p32)) * h * h < 1e-2 * abs(lam0_h2)



def test_growth_script_runs_leapfrog_on_the_cpu():
    """apps/bf16_growth.py --integrator leapfrog on a CPU device at (4, 2, 2)
    cells: its four runs on kernel I's plain step (the control runs with
    the other model's lf2 tables), and lam0 of the tables, the same
    stencil as the RK4 step's."""
    from wave_fenics_tpu_torch.apps import bf16_growth

    rec = bf16_growth.run(cells=(4, 2, 2), steps=20, every=10, fit=10, device="cpu",
                          integrator="leapfrog")
    assert rec["integrator"] == "leapfrog"
    assert set(rec["runs"]) == set(bf16_growth.RUNS)
    assert all([s for s, _ in series] == [10, 20] for series in rec["runs"].values())
    h = 0.1 / 4
    assert rec["lam0"]["bf16 tables"] * h * h == pytest.approx(6.1887e4, rel=1e-3)
    assert abs(rec["lam0"]["f32 tables"]) < 1e-3 * rec["lam0"]["bf16 tables"]
