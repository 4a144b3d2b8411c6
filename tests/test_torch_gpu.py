"""The hand-written CUDA kernels (A to K) against their plain versions
(float64; kernel E also in float32), kernels A, B, C, D, E, F, G and J also
from output buffers full of NaN; the app paths' launch counts, and the
imported-mesh workflow (the app's general branch with --output, probe
recording, the energy) on kernels K, F and A against the CPU; the general
set-up kernels (native.py) against their plain versions and the card's
set-up against the NumPy route; the distributed structured box
(``parallel/``): A, H and I on the value-halo layouts against their plain
versions from NaN, every sharded path against the one-device solve, and
the app's ``--ndev``.

Every test here needs a CUDA card and skips without one. The file imports
only torch and the port, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from wave_fenics_tpu_torch.apps import planar3d_app
from wave_fenics_tpu_torch.benchmarks.general_solve import LEAPFROG_DT, min_edge, perturbed_box
from wave_fenics_tpu_torch.core.dofmap import build_dofmap
from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave
from wave_fenics_tpu_torch.models.linear_wave import LinearWave
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.ops import (
    _cuda,
    general,
    lf2step,
    lfstep,
    mass,
    rk4step,
    rk42step,
    stiffness,
    tiling,
    wave,
)
from wave_fenics_tpu_torch.ops.operators import GeneralOperators, StructuredOperators
from wave_fenics_tpu_torch.solvers.cg import cg

pytestmark = pytest.mark.gpu

F64 = torch.float64
DT = 1e-9
GS = (1.0, 0.7, 0.4, 0.1)  # distinct per-stage sources
TOL = 1e-12  # f64; only association order differs between kernel and plain


@pytest.fixture
def cuda():
    """The CUDA device, with TF32 off for the plain versions; skips the test
    where no card is present (decided at run time, not at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(p, device, shape=(4, 2, 2), tile_x=16, dtype=F64):
    mesh = box_mesh(shape, (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    return PaddedLinearWave(
        LinearWave(mesh, p=p, dtype=dtype, device=device), tile_x=tile_x)


# the step kernels (A, C) at every p they take, on the smallest tile the
# step path allows, and on grids whose interior is no multiple of the
# tiling's CX, TY or TZ ((5,3,3) cells at p=4: 21 x 13 x 13 points in
# f64 tiles of 13 x 14; (9,4,8) cells: 37 x 17 x 33 points in chunks of 13
# and tiles of 9 x 18, ragged along each axis; tests/test_torch_tiling.py)
STEP_CASES = [(p, (4, 2, 2)) for p in range(1, 9)] + [(4, (5, 3, 3)), (4, (9, 4, 8))]


def _step_model(p, shape, device, dtype=F64):
    return _model(p, device, shape, tile_x=max(16, rk4step._off0(p)), dtype=dtype)


def _random_padded(layout, seed, device, scale=1.0):
    x = np.zeros(layout.padded_shape)
    x[layout.interior] = scale * np.random.default_rng(seed).standard_normal(layout.shape)
    return torch.as_tensor(x, device=device)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _assert_state_close(u, v, u_ref, v_ref, tol=TOL):
    vmax = float(v_ref.abs().max())
    assert vmax > 0.0
    assert float((u - u_ref).abs().max()) <= tol * max(vmax, 1.0)
    assert float((v - v_ref).abs().max()) <= tol * vmax


def _padding_zero(pm, *fields):
    for x in fields:
        outside = x.clone()
        outside[pm.layout.interior] = 0.0
        assert float(outside.abs().max()) == 0.0


@pytest.mark.parametrize("p", [2, 4])
def test_apply_flat_cuda_matches_plain(cuda, p):
    pm = _model(p, cuda)
    x = _random_padded(pm.layout, 14, cuda)
    n0 = wave.apply_flat_cuda.launches
    y = pm._apply(x)
    torch.cuda.synchronize()
    assert wave.apply_flat_cuda.launches == n0 + 1
    ref = wave.apply_flat_plain(x, pm.layout, pm.flat_tables)
    assert _rel(y, ref) <= TOL
    outside = y.clone()
    outside[pm.layout.interior] = 0.0
    assert float(outside.abs().max()) == 0.0


@pytest.mark.parametrize("cells", [(4, 2, 2), (5, 3, 3)])
@pytest.mark.parametrize("p", range(1, 9))
def test_cuda_apply_flat_tiled_every_p_over_nan(cuda, p, cells):
    """Kernel B (csrc/flat_tiled.cu) at every p it takes, on (4,2,2) cells
    and on (5,3,3), ragged against its tiling, from an output buffer full of
    NaN: against its plain version and its plain twin in the kernel's sum
    order (1e-12), the padding of y exactly zero."""
    pm = _model(p, cuda, cells)
    x = _random_padded(pm.layout, 100 + p, cuda)
    y = wave.apply_flat_cuda(x, pm.layout, pm.stencil, out=torch.full_like(x, float("nan")))
    torch.cuda.synchronize()
    assert _rel(y, wave.apply_flat_plain(x, pm.layout, pm.flat_tables)) <= TOL
    assert _rel(y, wave.apply_stencil_plain(x, pm.layout, pm.stencil)) <= TOL
    _padding_zero(pm, y)


def test_apply_flat_cuda_rejects_bad_operands(cuda):
    pm = _model(2, cuda)
    x = torch.zeros(pm.layout.padded_shape, dtype=F64, device=cuda)
    with pytest.raises(TypeError):
        wave.apply_flat_cuda(x.float(), pm.layout, pm.stencil)
    with pytest.raises(ValueError):
        wave.apply_flat_cuda(x, pm.layout, pm.stencil, out=x)
    with pytest.raises(ValueError):
        wave.apply_flat_cuda(x.transpose(1, 2), pm.layout, pm.stencil)


@pytest.mark.parametrize("p,shape", STEP_CASES)
def test_cuda_step_matches_plain(cuda, p, shape):
    pm = _step_model(p, shape, cuda)
    u0 = _random_padded(pm.layout, 31, cuda)
    v0 = _random_padded(pm.layout, 32, cuda, scale=1e3)
    args = (DT, GS, pm.layout, pm.base.c0)
    n0 = rk4step.rk4_step_lean_cuda.launches
    uk, vk = rk4step.rk4_step_lean(u0, v0, *args, pm.step_tables, pm.stencil,
                                   pm.src_x, pm.abc_x)
    torch.cuda.synchronize()
    assert rk4step.rk4_step_lean_cuda.launches == n0 + rk4step.LAUNCHES_PER_STEP
    up, vp = rk4step.rk4_step_lean_plain(u0, v0, *args, pm.step_tables)
    vmax = float(vp.abs().max())
    assert float((uk - up).abs().max()) <= TOL * max(vmax, 1.0)
    assert float((vk - vp).abs().max()) <= TOL * vmax


@pytest.mark.parametrize("p", [2, 4])
def test_cuda_solve_step_n_matches_cpu(cuda, p):
    u_c, v_c, _ = _model(p, "cpu").solve_step_n(0.0, DT, 25)
    u_g, v_g, _ = _model(p, cuda).solve_step_n(0.0, DT, 25)
    vmax = float(v_c.abs().max())
    assert vmax > 0.0
    assert float((u_g.cpu() - u_c).abs().max()) <= TOL * max(vmax, 1.0)
    assert float((v_g.cpu() - v_c).abs().max()) <= TOL * vmax


def test_cuda_step_rejects_aliasing(cuda):
    pm = _model(2, cuda)
    u0 = _random_padded(pm.layout, 33, cuda)
    v0 = _random_padded(pm.layout, 34, cuda)
    with pytest.raises(ValueError, match="alias"):
        rk4step.rk4_step_lean_cuda(
            u0, v0, DT, GS, pm.layout, pm.base.c0, pm.stencil,
            pm.step_tables.W1, pm.step_tables.W2, pm.src_x, pm.abc_x,
            out=(u0, v0),
        )


@pytest.mark.parametrize("p,shape", STEP_CASES)
def test_cuda_full_step_matches_plain_and_lean(cuda, p, shape):
    """Kernel C against its plain version (1e-12) and against kernel A (the
    same step in the lean algebra, 1e-13)."""
    pm = _step_model(p, shape, cuda)
    u0 = _random_padded(pm.layout, 35, cuda)
    v0 = _random_padded(pm.layout, 36, cuda, scale=1e3)
    args = (DT, GS, pm.layout, pm.base.c0)
    n0 = rk4step.rk4_step_full_cuda.launches
    uk, vk = rk4step.rk4_step_full(u0, v0, *args, pm.step_tables, pm.stencil,
                                   pm.src_x, pm.abc_x)
    torch.cuda.synchronize()
    assert rk4step.rk4_step_full_cuda.launches == n0 + rk4step.LAUNCHES_PER_STEP
    up, vp = rk4step.rk4_step_full_plain(u0, v0, *args, pm.step_tables)
    _assert_state_close(uk, vk, up, vp)
    ul, vl = rk4step.rk4_step_lean(u0, v0, *args, pm.step_tables, pm.stencil,
                                   pm.src_x, pm.abc_x)
    _assert_state_close(uk, vk, ul, vl, 1e-13)
    _padding_zero(pm, uk, vk)


@pytest.mark.parametrize("lean", [True, False])
@pytest.mark.parametrize("p,shape", [(1, (4, 2, 2)), (4, (9, 4, 8)), (8, (4, 2, 2))])
def test_cuda_step_writes_zero_padding_over_nan(cuda, p, shape, lean):
    """Kernels A and C write every point of their outputs and scratch: from
    buffers full of NaN the step ends with exactly zero padding, finite
    interiors and the values of a step from zeroed buffers."""
    pm = _step_model(p, shape, cuda)
    u0 = _random_padded(pm.layout, 37, cuda)
    v0 = _random_padded(pm.layout, 38, cuda, scale=1e3)
    step = rk4step.rk4_step_lean_cuda if lean else rk4step.rk4_step_full_cuda
    args = (u0, v0, DT, GS, pm.layout, pm.base.c0, pm.stencil, pm.step_tables.W1,
            pm.step_tables.W2, pm.src_x, pm.abc_x)
    bufs = [torch.full_like(u0, float("nan")) for _ in range(5)]
    uk, vk = step(*args, out=tuple(bufs[:2]), scratch=tuple(bufs[2:]))
    torch.cuda.synchronize()
    _padding_zero(pm, uk, vk, *bufs[2:])
    assert bool(torch.isfinite(uk).all() and torch.isfinite(vk).all())
    zeros = [torch.zeros_like(u0) for _ in range(5)]
    uz, vz = step(*args, out=tuple(zeros[:2]), scratch=tuple(zeros[2:]))
    assert torch.equal(uk, uz) and torch.equal(vk, vz)


def _stage_launches(pm, u0, v0, bufs, lean, padding_first=None):
    """Kernel A's (C's) four stage launches from (u0, v0) into ``bufs`` =
    (u1, v1, kv0, kv1, kv2), with the padding layer where
    ``tiling.tma_padding_first`` puts it or, forced, first or last."""
    launcher = "wave_rk4_stage" if lean else "wave_rk4_full_stage"
    for j in range(4):
        args = rk4step.stage_launch_args(
            j, u0, v0, *bufs[2:], bufs[2 + j] if j < 3 else bufs[4], *bufs[:2],
            pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x, DT, GS[j], pm.base.c0,
            pm.layout, pm.stencil, padding_first=padding_first)
        _cuda.launch(launcher, u0.dtype, u0.device, *args)
    return bufs[0], bufs[1]


@pytest.mark.parametrize("dtype", [F64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("lean", [True, False])
def test_cuda_step_every_p_and_dtype_over_nan(cuda, lean, p, dtype):
    """Kernels A and C at every p, in f64, f32 and bf16, on (5,3,3) cells
    (ragged against the tiles and chunks), from output and scratch buffers
    full of NaN, with the padding layer first and last: against the plain
    version (f64 1e-12 on the card, f32 1e-5 on the card, bf16 its plain
    twin on the CPU at 1e-2), the padding of u1, v1 and kv0..kv2 exactly
    zero, nothing left NaN, and both orders of the grid bitwise equal."""
    if dtype == torch.bfloat16:
        pm, pc = (_bf16_model(p, d, (5, 3, 3), lean) for d in (cuda, "cpu"))
        u0 = _bf16_state(pm.layout, 60 + p, cuda)
        v0 = _bf16_state(pm.layout, 61 + p, cuda, 1e3)
    else:
        pm = _step_model(p, (5, 3, 3), cuda, dtype)
        u0 = _random_padded(pm.layout, 60 + p, cuda).to(dtype)
        v0 = _random_padded(pm.layout, 61 + p, cuda, scale=1e3).to(dtype)
    plain = rk4step.rk4_step_lean_plain if lean else rk4step.rk4_step_full_plain
    outs = []
    for first in (True, False):
        bufs = [torch.full_like(u0, float("nan")) for _ in range(5)]
        outs.append(_stage_launches(pm, u0, v0, bufs, lean, first))
        torch.cuda.synchronize()
        _padding_zero(pm, *bufs)
        assert all(bool(torch.isfinite(x).all()) for x in bufs)
    (uk, vk), (ul, vl) = outs
    assert torch.equal(uk, ul) and torch.equal(vk, vl)
    args = (DT, GS, pm.layout, pm.base.c0)
    if dtype == torch.bfloat16:
        up, vp = plain(u0.cpu(), v0.cpu(), *args, pc.step_tables)
        assert _bf16_rel(uk, up) <= ONE_BF16 and _bf16_rel(vk, vp) <= ONE_BF16
    else:
        up, vp = plain(u0, v0, *args, pm.step_tables)
        _assert_state_close(uk, vk, up, vp, TOL if dtype == F64 else 1e-5)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_cuda_rk_stage_matches_plain(cuda, p):
    """Kernel D, one stage from random inputs (p=8: 17 taps per axis)."""
    pm = _model(p, cuda)
    ins = [_random_padded(pm.layout, 70 + i, cuda, scale=s)
           for i, s in enumerate((1.0, 1e3, 1e3, 1e9, 1.0, 1e3))]
    sargs = (0.5 * DT, DT / 3.0, 0.7, pm.layout, pm.base.c0)
    face = (pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
    n0 = wave.rk_stage_cuda.launches
    got = wave.rk_stage(*ins, *sargs, pm.flat_tables, pm.stencil, *face)
    torch.cuda.synchronize()
    assert wave.rk_stage_cuda.launches == n0 + 1
    want = wave.rk_stage_plain(*ins, *sargs, pm.flat_tables, *face)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL
    _padding_zero(pm, got[1])


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_cuda_rk_stage_over_nan_and_in_place(cuda, p, in_place):
    """Kernel D (the tiled TMA kernel) on (5,3,3) cells, ragged against its
    tiling, from inputs that are random in the padding too and output
    buffers full of NaN, out of place and with ua'/va' written over ua/va
    as solve_fused_n does: within 1e-12 of the plain version in f64; in the
    padding kv' exactly 0 and va' exactly va, vn and ua' their point-wise
    values."""
    pm = _model(p, cuda, shape=(5, 3, 3))
    rng = np.random.default_rng(80 + p)
    ins = [torch.as_tensor(s * rng.standard_normal(pm.layout.padded_shape), device=cuda)
           for s in (1.0, 1e3, 1e3, 1e9, 1.0, 1e3)]
    sargs = (0.5 * DT, DT / 3.0, 0.7, pm.layout, pm.base.c0)
    face = (pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
    want = wave.rk_stage_plain(*ins, *sargs, pm.flat_tables, *face)
    ua, va = ins[4].clone(), ins[5].clone()
    nan = lambda: torch.full_like(ua, float("nan"))  # noqa: E731
    out = (nan(), nan(), ua, va) if in_place else (nan(), nan(), nan(), nan())
    got = wave.rk_stage_cuda(*ins[:4], ua, va, *sargs, pm.stencil, *face, out=out)
    torch.cuda.synchronize()
    if in_place:
        assert got[2] is ua and got[3] is va
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) <= TOL
    pad = torch.ones(pm.layout.padded_shape, dtype=torch.bool, device=cuda)
    pad[pm.layout.interior] = False
    assert float(got[1][pad].abs().max()) == 0.0
    assert torch.equal(got[3][pad], ins[5][pad])
    vn = ins[2] + (0.5 * DT) * ins[3]
    assert _rel(got[0][pad], vn[pad]) <= TOL
    assert _rel(got[2][pad], ins[4][pad] + (DT / 3.0) * vn[pad]) <= TOL


@pytest.mark.parametrize("p", [2, 4, 8])
def test_cuda_solve_fused_n_matches_cpu(cuda, p):
    u_c, v_c, _ = _model(p, "cpu").solve_fused_n(0.0, DT, 10)
    pm = _model(p, cuda)
    n0 = wave.rk_stage_cuda.launches
    u_g, v_g, _ = pm.solve_fused_n(0.0, DT, 10)
    assert wave.rk_stage_cuda.launches == n0 + 40
    _assert_state_close(u_g.cpu(), v_g.cpu(), u_c, v_c)
    _padding_zero(pm, u_g, v_g)


def _lf_model(p, device):
    """The smallest model on which both leapfrog kernels apply at ``p``
    (kernel I's 3p-deep slab halo needs tile 24 from p = 6)."""
    return _model(p, device, tile_x=max(16, lf2step._off0(p)))


@pytest.mark.parametrize("p", range(1, 9))
def test_cuda_lf_step_matches_plain(cuda, p):
    """Kernel H (OPEN, CLOSE on the tiled TMA kernel), one step from a
    random state, at every p it takes."""
    pm = _lf_model(p, cuda)
    u0 = _random_padded(pm.layout, 37, cuda)
    v0 = _random_padded(pm.layout, 38, cuda, scale=1e3)
    args = (DT, 1.0, 0.6, pm.layout, pm.base.c0)
    n0 = lfstep.lf_step_cuda.launches
    uk, vk = lfstep.lf_step(u0, v0, *args, pm.lf_tables, pm.stencil, pm.src_x,
                            pm.abc_x)
    torch.cuda.synchronize()
    assert lfstep.lf_step_cuda.launches == n0 + lfstep.LAUNCHES_PER_STEP
    up, vp = lfstep.lf_step_plain(u0, v0, *args, pm.lf_tables)
    _assert_state_close(uk, vk, up, vp)
    _padding_zero(pm, uk, vk)


@pytest.mark.parametrize("p", range(1, 9))
def test_cuda_lf2_step_matches_plain(cuda, p):
    """Kernel I (OPEN, MID, CLOSE on the tiled TMA kernel), two steps from
    a random state, at every p it takes."""
    pm = _lf_model(p, cuda)
    u0 = _random_padded(pm.layout, 39, cuda)
    v0 = _random_padded(pm.layout, 40, cuda, scale=1e3)
    args = (DT, 1.0, 0.6, 0.2, pm.layout, pm.base.c0)
    n0 = lf2step.lf2_step_cuda.launches
    uk, vk = lf2step.lf2_step(u0, v0, *args, pm.lf2_tables, pm.stencil,
                              pm.src_x, pm.abc_x)
    torch.cuda.synchronize()
    assert lf2step.lf2_step_cuda.launches == n0 + lf2step.LAUNCHES_PER_CALL
    up, vp = lf2step.lf2_step_plain(u0, v0, *args, pm.lf2_tables)
    _assert_state_close(uk, vk, up, vp)
    _padding_zero(pm, uk, vk)


@pytest.mark.parametrize("p", [1, 4, 8])
def test_cuda_lf_phases_over_nan(cuda, p):
    """Kernels H and I write every padded point of their outputs and
    scratch: from buffers full of NaN the padding comes out exactly 0 (in
    u_out and v_out of every phase) and the interior matches the plain
    step, on (5,3,3) cells, ragged against the tiling."""
    pm = _model(p, cuda, shape=(5, 3, 3), tile_x=max(16, lf2step._off0(p)))
    u0 = _random_padded(pm.layout, 41, cuda)
    v0 = _random_padded(pm.layout, 42, cuda, scale=1e3)
    face = (pm.layout, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2, pm.src_x,
            pm.abc_x)
    nan = [torch.full_like(u0, float("nan")) for _ in range(5)]
    uk, vk = lfstep.lf_step_cuda(u0, v0, DT, 1.0, 0.6, *face, out=tuple(nan[:2]),
                                 scratch=nan[2])
    torch.cuda.synchronize()
    up, vp = lfstep.lf_step_plain(u0, v0, DT, 1.0, 0.6, pm.layout, pm.base.c0,
                                  pm.lf_tables)
    _assert_state_close(uk, vk, up, vp)
    _padding_zero(pm, uk, vk, nan[2])
    nan = [torch.full_like(u0, float("nan")) for _ in range(5)]
    uk, vk = lf2step.lf2_step_cuda(u0, v0, DT, 1.0, 0.6, 0.2, *face,
                                   out=tuple(nan[:2]), scratch=tuple(nan[2:]))
    torch.cuda.synchronize()
    up, vp = lf2step.lf2_step_plain(u0, v0, DT, 1.0, 0.6, 0.2, pm.layout, pm.base.c0,
                                    pm.lf2_tables)
    _assert_state_close(uk, vk, up, vp)
    _padding_zero(pm, uk, vk, *nan[2:])


@pytest.mark.parametrize("nsteps", [24, 25])
def test_cuda_solve_lf2_n_matches_cpu(cuda, nsteps):
    """Kernel I in the solver, an odd last step through kernel H."""
    u_c, v_c, _ = _model(4, "cpu").solve_lf2_n(0.0, DT, nsteps)
    n2, n1 = lf2step.lf2_step_cuda.launches, lfstep.lf_step_cuda.launches
    u_g, v_g, _ = _model(4, cuda).solve_lf2_n(0.0, DT, nsteps)
    assert lf2step.lf2_step_cuda.launches == n2 + 3 * (nsteps // 2)
    assert lfstep.lf_step_cuda.launches == n1 + 2 * (nsteps % 2)
    _assert_state_close(u_g.cpu(), v_g.cpu(), u_c, v_c)


def test_cuda_new_kernels_reject_aliasing(cuda):
    pm = _model(2, cuda)
    u0 = _random_padded(pm.layout, 45, cuda)
    v0 = _random_padded(pm.layout, 46, cuda)
    with pytest.raises(ValueError, match="alias"):
        lfstep.lf_step_cuda(u0, v0, DT, 1.0, 0.5, pm.layout, pm.base.c0,
                            pm.stencil, pm.face_w1, pm.face_w2, pm.src_x,
                            pm.abc_x, out=(u0, torch.empty_like(v0)))
    with pytest.raises(ValueError, match="alias"):
        lf2step.lf2_step_cuda(u0, v0, DT, 1.0, 0.5, 0.2, pm.layout, pm.base.c0,
                              pm.stencil, pm.face_w1, pm.face_w2, pm.src_x,
                              pm.abc_x, scratch=(v0, u0, u0))
    with pytest.raises(ValueError, match="alias"):
        wave.rk_stage_cuda(u0, u0, v0, v0, u0, v0, 0.0, DT, 1.0, pm.layout,
                           pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2,
                           pm.src_x, pm.abc_x,
                           out=(u0, torch.empty_like(u0), torch.empty_like(u0),
                                torch.empty_like(u0)))


def _grid(shape, seed, device):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape),
                           device=device)


@pytest.mark.parametrize("p,cells", [(2, (4, 2, 3)), (4, (4, 2, 2)), (4, (3, 3, 2))])
def test_cuda_stiffness_grid_matches_plain(cuda, p, cells):
    """Kernel F through StructuredOperators.stiffness (p=4 on 4 cells: the
    ragged Nx = 17 of the JAX tests) against its plain version on the same
    tables and against the CPU separable stiffness."""
    ops = StructuredOperators(box_mesh(cells, (1.0, 0.8, 1.2)), p, dtype=F64)
    x = _grid(ops.grid_shape, 50 + p, cuda)
    n0 = stiffness.stiffness_grid_cuda.launches
    y = ops.stiffness(x, 1500.0)
    torch.cuda.synchronize()
    assert stiffness.stiffness_grid_cuda.launches == n0 + 1
    assert tuple(y.shape) == ops.grid_shape
    tables = stiffness.GridStiffnessTables(*(torch.as_tensor(t, device=cuda) for t in
                                             stiffness.stiffness_grid_tables(
        ops._sepA, ops._seplines, ops.grid_shape, p, -1500.0**2, F64)))
    assert _rel(y, stiffness.stiffness_grid_plain(x, tables, p)) <= TOL
    assert _rel(y.cpu(), ops.stiffness(x.cpu(), 1500.0)) <= TOL
    # a 0-d tensor c0 is read with float()
    y0 = ops.stiffness(x, torch.tensor(1500.0, dtype=F64, device=cuda))
    assert _rel(y0, y) == 0.0


@pytest.mark.parametrize("cells", [(4, 2, 3), (5, 3, 4)])
@pytest.mark.parametrize("p", range(1, 11))
def test_cuda_stiffness_tiled_every_p_over_nan(cuda, p, cells):
    """Kernel F (csrc/stiffness_tiled.cu) at every p StructuredOperators
    takes, on grids whose three extents differ and are ragged against the
    tiling, from an output buffer full of NaN: against its plain version
    (1e-12), every point written."""
    ops = StructuredOperators(box_mesh(cells, (1.0, 0.8, 1.2)), p, dtype=F64)
    tables = stiffness.GridStiffnessTables(*(torch.as_tensor(t, device=cuda) for t in
                                             stiffness.stiffness_grid_tables(
        ops._sepA, ops._seplines, ops.grid_shape, p, -1500.0**2, F64)))
    x = _grid(ops.grid_shape, 110 + p, cuda)
    y = stiffness.stiffness_grid_cuda(x, tables, p, out=torch.full_like(x, float("nan")))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert _rel(y, stiffness.stiffness_grid_plain(x, tables, p)) <= TOL


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_cuda_mass_apply_matches_plain(cuda, p):
    """Kernel G (p=8 in f64: 105 KB of dynamic shared memory) against its
    plain version; the padding of y exactly zero."""
    layout, tables, _ = mass.bp1_setup(box_mesh((3, 2, 2), (1.0, 0.8, 1.2)), p, F64, cuda)
    x = _random_padded(layout, 60 + p, cuda)
    n0 = mass.mass_apply_cuda.launches
    y = mass.mass_apply(x, layout, tables)
    torch.cuda.synchronize()
    assert mass.mass_apply_cuda.launches == n0 + 1
    assert _rel(y, mass.mass_apply_plain(x, layout, tables)) <= TOL
    outside = y.clone()
    outside[layout.interior] = 0.0
    assert float(outside.abs().max()) == 0.0


@pytest.mark.parametrize("cells", [(3, 2, 2), (5, 3, 4)])
@pytest.mark.parametrize("p", range(1, 9))
def test_cuda_mass_tiled_every_p_over_nan(cuda, p, cells):
    """Kernel G (csrc/mass_tiled.cu) at every p it takes, on a grid ragged
    against its tiling too, from an output buffer full of NaN: against the
    plain version and its plain twin in the kernel's z, y, x order (1e-12),
    the padding of y exactly zero."""
    layout, tables, _ = mass.bp1_setup(box_mesh(cells, (1.0, 0.8, 1.2)), p, F64, cuda)
    x = _random_padded(layout, 90 + p, cuda)
    y = mass.mass_apply_cuda(x, layout, tables, out=torch.full_like(x, float("nan")))
    torch.cuda.synchronize()
    assert _rel(y, mass.mass_apply_plain(x, layout, tables)) <= TOL
    assert _rel(y, mass.mass_apply_zyx_plain(x, layout, tables)) <= TOL
    outside = y.clone()
    outside[layout.interior] = 0.0
    assert float(outside.abs().max()) == 0.0


@pytest.mark.parametrize("p", [2, 4])
def test_cuda_mass_gauss_matches_cpu(cuda, p):
    ops = StructuredOperators(box_mesh((3, 2, 2), (1.0, 0.8, 1.2)), p, dtype=F64)
    x = _grid(ops.grid_shape, 70 + p, "cpu")
    n0 = mass.mass_apply_cuda.launches
    y = ops.mass_gauss(x.to(cuda))
    torch.cuda.synchronize()
    assert mass.mass_apply_cuda.launches == n0 + 1
    assert _rel(y.cpu(), ops.mass_gauss(x)) <= TOL


@pytest.mark.parametrize("precond", [False, True])
def test_cuda_bp1_cg_matches_plain_matvec(cuda, precond):
    """CG on kernel G against CG on the plain matvec: the same iteration
    count (f64), solutions to 1e-10, one launch per matvec.

    rtol 1e-8 lets both solves converge well inside kmax. The last squared
    residuals lie below the stopping threshold rtol^2 |r0|^2, where the two
    matvecs' 1e-16 differences are no longer small against them, so they
    are compared against the threshold: both below it, and within 1 % of
    it of each other."""
    layout, tables, pre = mass.bp1_setup(box_mesh((4, 4, 3), (1.0, 1.0, 1.0)), 2,
                                         F64, cuda, precond=precond)
    b = layout.pad(_grid(layout.shape, 80, cuda))
    n0 = mass.mass_apply_cuda.launches
    xk, kk, rk = cg(lambda v: mass.mass_apply_cuda(v, layout, tables), b,
                    kmax=400, rtol=1e-8, precond=pre)
    assert mass.mass_apply_cuda.launches == n0 + 1 + kk
    xp, kp, rp = cg(lambda v: mass.mass_apply_plain(v, layout, tables), b,
                    kmax=400, rtol=1e-8, precond=pre)
    assert 0 < kk < 400 and kk == kp
    assert _rel(xk, xp) <= 1e-10
    threshold = 1e-8**2 * float(torch.dot(b.reshape(-1), b.reshape(-1)))  # r0 = b
    rk, rp = float(rk), float(rp)
    assert max(rk, rp) < threshold and abs(rk - rp) <= 1e-2 * threshold, (
        rk, rp, threshold)


def test_cuda_linear_wave_solve_matches_cpu(cuda):
    """The unpadded eager model on the card: kernel F in f1, four launches
    per RK4 step, the same state as on the CPU."""
    mesh = box_mesh((4, 2, 2), (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    u_c, v_c, n = LinearWave(mesh, p=4, dtype=F64, device="cpu").solve(0.0, 25 * DT, DT)
    n0 = stiffness.stiffness_grid_cuda.launches
    u_g, v_g, n_g = LinearWave(mesh, p=4, dtype=F64, device=cuda).solve(0.0, 25 * DT, DT)
    assert n_g == n == 25
    assert stiffness.stiffness_grid_cuda.launches == n0 + 4 * n
    _assert_state_close(u_g.cpu(), v_g.cpu(), u_c, v_c)


def test_cuda_operator_kernels_reject_bad_operands(cuda):
    layout, tables, _ = mass.bp1_setup(box_mesh((2, 2, 2), (1.0, 1.0, 1.0)), 2, F64, cuda)
    x = torch.zeros(layout.padded_shape, dtype=F64, device=cuda)
    with pytest.raises(TypeError):
        mass.mass_apply_cuda(x.float(), layout, tables)
    with pytest.raises(ValueError, match="alias"):
        mass.mass_apply_cuda(x, layout, tables, out=x)
    ops = StructuredOperators(box_mesh((2, 2, 2), (1.0, 1.0, 1.0)), 2, dtype=F64)
    g = torch.zeros(ops.grid_shape, dtype=F64, device=cuda)
    gt = stiffness.GridStiffnessTables(*(torch.as_tensor(t, device=cuda) for t in
                                         stiffness.stiffness_grid_tables(
        ops._sepA, ops._seplines, ops.grid_shape, 2, -1.0, F64)))
    with pytest.raises(ValueError):
        stiffness.stiffness_grid_cuda(g[:, :, :-1], gt, 2)
    with pytest.raises(ValueError, match="alias"):
        stiffness.stiffness_grid_cuda(g, gt, 2, out=g)


def _general_ops(p, rule="gll", cells=None):
    """GeneralOperators (f64) on a perturbed box of the JAX tests' sizes."""
    cells = cells or ((2, 2, 2) if p >= 6 else (3, 2, 2) if p >= 5
                      else (4, 3, 3) if p >= 3 else (5, 4, 3))
    mesh, _ = perturbed_box(cells, h=0.25)
    return GeneralOperators(mesh, build_dofmap(mesh, p), dtype=F64, rule=rule)


@pytest.mark.parametrize("rule,p", [("gll", 1), ("gll", 2), ("gll", 4), ("gll", 6),
                                    ("gauss", 1), ("gauss", 2), ("gauss", 4)])
def test_cuda_general_modes_match_plain(cuda, rule, p):
    """Kernel K through GeneralOperators.mass/stiffness (collocated: mass,
    stiffness; Gauss: mass_gauss, stiffness_gauss) against its plain version
    on the same tables and against the CPU dispatch; one count per apply."""
    ops = _general_ops(p, rule)
    x = _grid((ops.ndofs,), 90 + p, cuda)
    for op, coeff in (("mass", 1.0), ("stiffness", -1500.0**2)):
        mode = op if rule == "gll" else f"{op}_gauss"
        n0 = general.general_apply_cuda.launches
        y = ops.mass(x) if op == "mass" else ops.stiffness(x, 1500.0)
        torch.cuda.synchronize()
        assert general.general_apply_cuda.launches == n0 + 1
        assert _rel(y, general.general_apply_plain(x, ops.tables(mode, cuda), coeff)) <= TOL
        y_cpu = ops.mass(x.cpu()) if op == "mass" else ops.stiffness(x.cpu(), 1500.0)
        assert _rel(y.cpu(), y_cpu) <= TOL


@pytest.mark.parametrize("p", [2, 4])
def test_cuda_general_affine_matches_indexed(cuda, p):
    """Affine cells (a box): K's rank-1 geometry against the per-node
    indexed oracle."""
    mesh = box_mesh((4, 3, 2), (1.0, 0.8, 0.9)).to_hex_mesh()
    ops = GeneralOperators(mesh, build_dofmap(mesh, p), dtype=F64)
    assert ops.affine and ops.tables("stiffness", cuda).affine
    x = _grid((ops.ndofs,), 95 + p, cuda)
    assert _rel(ops.stiffness(x, 3.0), ops.stiffness_indexed(x, 3.0)) <= TOL
    assert _rel(ops.mass(x), ops.spectral_mass_roundtrip(x)) <= TOL


def test_cuda_general_apply_is_bitwise_deterministic(cuda):
    """No atomics: two applies of every mode agree bit for bit."""
    for rule in ("gll", "gauss"):
        ops = _general_ops(4, rule)
        x = _grid((ops.ndofs,), 97, cuda)
        for op in ("mass", "stiffness"):
            t = ops.tables(op if rule == "gll" else f"{op}_gauss", cuda)
            assert torch.equal(general.general_apply_cuda(x, t, -2.0),
                               general.general_apply_cuda(x, t, -2.0))


def test_cuda_general_shuffled_cells_match_plain(cuda):
    """Kernel K on a mesh whose cells are shuffled (a greedy colouring with
    no parity structure): every mode against its plain version, two applies
    bitwise equal."""
    mesh, _ = perturbed_box((5, 4, 3), h=0.25)
    perm = np.random.default_rng(7).permutation(mesh.ncells)
    shuffled = type(mesh)(points=mesh.points, cells=mesh.cells[perm])
    for rule in ("gll", "gauss"):
        ops = GeneralOperators(shuffled, build_dofmap(shuffled, 2), dtype=F64, rule=rule)
        x = _grid((ops.ndofs,), 99, cuda)
        for op, coeff in (("mass", 1.0), ("stiffness", -1500.0**2)):
            t = ops.tables(op if rule == "gll" else f"{op}_gauss", cuda)
            y = general.general_apply_cuda(x, t, coeff)
            assert torch.equal(y, general.general_apply_cuda(x, t, coeff))
            assert _rel(y, general.general_apply_plain(x, t, coeff)) <= TOL


def test_cuda_general_raises_above_p6(cuda):
    """Kernel K takes p <= 6: a CUDA tensor at p = 7 raises and never runs
    the plain version; the CPU dispatch still runs it."""
    ops = _general_ops(7, cells=(1, 1, 2))
    x = _grid((ops.ndofs,), 98, "cpu")
    n0 = general.general_apply_cuda.launches
    with pytest.raises(ValueError, match="p <= 6"):
        ops.stiffness(x.to(cuda), 1500.0)
    with pytest.raises(ValueError, match="p <= 6"):
        ops.mass(x.to(cuda))
    assert general.general_apply_cuda.launches == n0
    assert torch.isfinite(ops.stiffness(x, 1500.0)).all()


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_cuda_general_wave_solve_n_matches_cpu(cuda, integrator):
    mesh, tags = perturbed_box((4, 3, 2))
    dt = 0.5 * min_edge(mesh) / (1500.0 * 4) * (LEAPFROG_DT if integrator == "leapfrog" else 1.0)
    u_c, v_c = GeneralLinearWave(mesh, 2, tags, dtype=F64, device="cpu").solve_n(
        0.0, dt, 10, integrator=integrator)
    n0 = general.general_apply_cuda.launches
    u_g, v_g = GeneralLinearWave(mesh, 2, tags, dtype=F64, device=cuda).solve_n(
        0.0, dt, 10, integrator=integrator)
    assert general.general_apply_cuda.launches == n0 + (40 if integrator == "rk4" else 11)
    _assert_state_close(u_g.cpu(), v_g.cpu(), u_c, v_c)


def _slab_model(p, device, shape=(2, 1, 1), dtype=F64, kernel="flat"):
    mesh = box_mesh(shape, (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    return PaddedLinearWave(LinearWave(mesh, p=p, dtype=dtype, device=device),
                            tile_x=16, kernel=kernel)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
@pytest.mark.parametrize("p,shape,kernel", [(9, (2, 1, 1), "flat"), (10, (2, 1, 1), "flat"),
                                            (10, (3, 2, 1), "flat"), (4, (4, 2, 2), "3d")])
def test_cuda_apply_slab_matches_plain(cuda, p, shape, kernel, dtype):
    """Kernel E (p > 8, or kernel='3d') through the model's _apply against
    its plain version; every padded cell exactly 0."""
    pm = _slab_model(p, cuda, shape, dtype, kernel)
    assert pm.kernel == "3d"
    x = _random_padded(pm.layout, 110 + p, cuda).to(dtype)
    n0 = wave.apply_slab_cuda.launches
    y = pm._apply(x)
    torch.cuda.synchronize()
    assert wave.apply_slab_cuda.launches == n0 + 1
    ref = wave.apply_slab_plain(x, pm.layout, pm.slab_tables)
    assert _rel(y, ref) <= (TOL if dtype == F64 else 1e-5)
    _padding_zero(pm, y)


@pytest.mark.parametrize("p", range(1, 11))
def test_cuda_apply_slab_every_p_over_nan(cuda, p):
    """Kernel E (the tiled TMA kernel) at every p it takes, on the 3D-slab
    layout of (3,2,3) cells, whose interior is no multiple of the tiling's
    TY or TZ at p = 4, 9 and 10, from an output buffer full of NaN: within
    1e-12 of the plain version in f64, and every padded cell exactly 0."""
    pm = _slab_model(p, cuda, (3, 2, 3), kernel="3d")
    x = _random_padded(pm.layout, 130 + p, cuda)
    y = torch.full_like(x, float("nan"))
    n0 = wave.apply_slab_cuda.launches
    wave.apply_slab_cuda(x, pm.layout, pm.slab_tables, out=y)
    torch.cuda.synchronize()
    assert wave.apply_slab_cuda.launches == n0 + 1
    assert bool(torch.isfinite(y).all())
    assert _rel(y, wave.apply_slab_plain(x, pm.layout, pm.slab_tables)) <= TOL
    _padding_zero(pm, y)


def test_cuda_slab_solve_n_matches_cpu(cuda):
    """RK4 on f1 at p = 9: four kernel-E launches per step, the CPU state."""
    u_c, v_c = _slab_model(9, "cpu").solve_n(0.0, DT, 5)
    pm = _slab_model(9, cuda)
    n0 = wave.apply_slab_cuda.launches
    u_g, v_g = pm.solve_n(0.0, DT, 5)
    assert wave.apply_slab_cuda.launches == n0 + 20
    _assert_state_close(u_g.cpu(), v_g.cpu(), u_c, v_c)


RK42_GS = (1.0, 0.8, 0.55, 0.3, 0.1)


def _rk42_model(p, device, lean=True):
    mesh = box_mesh((4, 2, 2), (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    return PaddedLinearWave(LinearWave(mesh, p=p, dtype=F64, device=device),
                            tile_x=24, lean=lean)


@pytest.mark.parametrize("p", [2, 4])
def test_cuda_rk42_step_matches_plain_and_two_c_steps(cuda, p):
    """Kernel J (7 launches) against its plain version (1e-12) and against
    two kernel-C steps (1e-13), from a random state."""
    pm = _rk42_model(p, cuda)
    u0 = _random_padded(pm.layout, 120 + p, cuda)
    v0 = _random_padded(pm.layout, 121 + p, cuda, scale=1e3)
    face = (pm.layout, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2,
            pm.src_x, pm.abc_x)
    n0, c0 = rk42step.rk42_step_cuda.launches, rk4step.rk4_step_full_cuda.launches
    uk, vk = rk42step.rk42_step(u0, v0, DT, RK42_GS, *face)
    torch.cuda.synchronize()
    assert rk42step.rk42_step_cuda.launches == n0 + rk42step.LAUNCHES_PER_CALL
    assert rk4step.rk4_step_full_cuda.launches == c0
    up, vp = rk42step.rk42_step_plain(u0, v0, DT, RK42_GS, *face)
    _assert_state_close(uk, vk, up, vp)
    g = RK42_GS
    uc, vc = rk4step.rk4_step_full_cuda(u0, v0, DT, (g[0], g[1], g[1], g[2]), *face)
    uc, vc = rk4step.rk4_step_full_cuda(uc, vc, DT, (g[2], g[3], g[3], g[4]), *face)
    _assert_state_close(uk, vk, uc, vc, 1e-13)
    _padding_zero(pm, uk, vk)


@pytest.mark.parametrize("p", range(1, 9))
def test_cuda_rk42_every_p_over_nan(cuda, p):
    """Kernel J at every p the two-step path takes (on the smallest tile >=
    its 6p halo, and at least 24) from output and scratch buffers full of
    NaN: against its plain version (1e-12) and two kernel-C steps (1e-13);
    the step boundary's outputs (u1, v1, kv0') and (u2, v2) with exactly
    zero padding and no NaN."""
    mesh = box_mesh((4, 2, 2), (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    pm = PaddedLinearWave(LinearWave(mesh, p=p, dtype=F64, device=cuda),
                          tile_x=max(24, rk42step._off0(p)), lean=False)
    assert pm.rk42_unavailable is None
    u0 = _random_padded(pm.layout, 140 + p, cuda)
    v0 = _random_padded(pm.layout, 141 + p, cuda, scale=1e3)
    face = (pm.layout, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2,
            pm.src_x, pm.abc_x)
    nan = [torch.full_like(u0, float("nan")) for _ in range(8)]
    uk, vk = rk42step.rk42_step_cuda(u0, v0, DT, RK42_GS, *face, out=tuple(nan[:2]),
                                     scratch=tuple(nan[2:]))
    torch.cuda.synchronize()
    up, vp = rk42step.rk42_step_plain(u0, v0, DT, RK42_GS, *face)
    _assert_state_close(uk, vk, up, vp)
    g = RK42_GS
    uc, vc = rk4step.rk4_step_full_cuda(u0, v0, DT, (g[0], g[1], g[1], g[2]), *face)
    uc, vc = rk4step.rk4_step_full_cuda(uc, vc, DT, (g[2], g[3], g[3], g[4]), *face)
    _assert_state_close(uk, vk, uc, vc, 1e-13)
    written = (uk, vk, *nan[5:])  # (u2, v2) and the boundary's u1, v1, kv0'
    _padding_zero(pm, *written)
    assert all(bool(torch.isfinite(x).all()) for x in written)


@pytest.mark.parametrize("p", [1, 4, 8])
def test_cuda_rk42_boundary_alone_matches_plain(cuda, p):
    """Kernel J's step boundary alone (one launch) from random (u0, v0) and
    stages kv0..kv2 into outputs full of NaN: against its plain version
    (1e-12 per field), the padding of u1, v1, kv0' exactly zero."""
    mesh = box_mesh((4, 2, 2), (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    pm = PaddedLinearWave(LinearWave(mesh, p=p, dtype=F64, device=cuda),
                          tile_x=max(24, rk42step._off0(p)))
    ins = [_random_padded(pm.layout, 150 + p + j, cuda, scale=s)
           for j, s in enumerate((1.0, 1e3, 1e9, 1e9, 1e9))]
    face = (pm.layout, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2,
            pm.src_x, pm.abc_x)
    out = tuple(torch.full_like(ins[0], float("nan")) for _ in range(3))
    got = rk42step._rk42_boundary_cuda(*ins, DT, 0.5, *face, out=out)
    torch.cuda.synchronize()
    want = rk42step.rk42_boundary_plain(*ins, DT, 0.5, *face)
    for x, w in zip(got, want):
        assert _rel(x, w) <= TOL
    _padding_zero(pm, *got)


@pytest.mark.parametrize("lean", [True, False])
@pytest.mark.parametrize("nsteps", [12, 13])
def test_cuda_solve_step2_n_launches_and_cpu(cuda, nsteps, lean):
    """solve_step2_n: 7 kernel-J launches per 2 steps; an odd last step
    through kernel A (lean) or C; the CPU state."""
    u_c, v_c, _ = _rk42_model(4, "cpu", lean).solve_step2_n(0.0, DT, nsteps)
    step = rk4step.rk4_step_lean_cuda if lean else rk4step.rk4_step_full_cuda
    nj, ns = rk42step.rk42_step_cuda.launches, step.launches
    u_g, v_g, _ = _rk42_model(4, cuda, lean).solve_step2_n(0.0, DT, nsteps)
    assert rk42step.rk42_step_cuda.launches == nj + 7 * (nsteps // 2)
    assert step.launches == ns + 4 * (nsteps % 2)
    _assert_state_close(u_g.cpu(), v_g.cpu(), u_c, v_c)


def test_cuda_rk42_rejects_aliasing(cuda):
    pm = _rk42_model(2, cuda)
    u0 = _random_padded(pm.layout, 130, cuda)
    v0 = _random_padded(pm.layout, 131, cuda)
    with pytest.raises(ValueError, match="alias"):
        rk42step.rk42_step_cuda(u0, v0, DT, RK42_GS, pm.layout, pm.base.c0,
                                pm.stencil, pm.face_w1, pm.face_w2, pm.src_x,
                                pm.abc_x, out=(u0, torch.empty_like(v0)))


@pytest.mark.parametrize("integrator,per_step,extra", [("rk4", 4, 0), ("leapfrog", 1, 1)])
def test_cuda_slab_app_paths(cuda, integrator, per_step, extra):
    """The app at p = 10 on a small grid: the f1/force paths on kernel E,
    with the warm-up call's launches (RK4: 4 per step; leapfrog: one per
    step and one at t0, per solve)."""
    wave.apply_slab_cuda.launches = 0
    out = planar3d_app.run(cells=(3, 2, 2), degree=10, dtype="f64", device="cuda",
                           steps=6, integrator=integrator)
    n = out["nsteps"]
    assert n == 6 and "kernel E" in out["solver_path"]
    assert wave.apply_slab_cuda.launches == per_step * (n + 1) + 2 * extra
    assert np.isfinite(out["u_norm"]) and out["u_norm"] > 0.0


# -- the imported-mesh workflow: the app's general branch, recording, energy --

COUNTERS = {"A": rk4step.rk4_step_lean_cuda, "B": wave.apply_flat_cuda,
            "C": rk4step.rk4_step_full_cuda, "D": wave.rk_stage_cuda,
            "E": wave.apply_slab_cuda, "F": stiffness.stiffness_grid_cuda,
            "G": mass.mass_apply_cuda, "H": lfstep.lf_step_cuda,
            "I": lf2step.lf2_step_cuda, "J": rk42step.rk42_step_cuda,
            "K": general.general_apply_cuda}


def _zero_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def _launched():
    return {k: fn.launches for k, fn in COUNTERS.items() if fn.launches}


def _imported_files(d):
    from wave_fenics_tpu_torch.core.io import write_xdmf_mesh, write_xdmf_meshtags

    hm, tags = perturbed_box((4, 2, 2), h=0.002)
    write_xdmf_mesh(str(d / "mesh.xdmf"), hm)
    write_xdmf_meshtags(str(d / "tags.xdmf"), hm, np.concatenate([tags[1], tags[2]]),
                        [1] * len(tags[1]) + [2] * len(tags[2]))
    return str(d / "mesh.xdmf"), str(d / "tags.xdmf")


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_cuda_imported_app_matches_cpu(cuda, tmp_path, integrator):
    """The app's imported-mesh branch on kernel K (f64, p=3, chunks of 7):
    the CPU run's state within 1e-12; K's launches, RK4 4 x (steps + 1
    warm-up step), leapfrog steps + one at each chunk's t0 + 2 for the
    warm-up step, and no other kernel; the --output file equal to the
    returned state."""
    from wave_fenics_tpu_torch.core.io import read_xdmf_attributes
    from wave_fenics_tpu_torch.utils.config import SimulationConfig

    mesh, tags = _imported_files(tmp_path)
    cfg = SimulationConfig()
    cfg.domain.degree = 3
    cfg.run.dtype = "f64"
    cfg.run.checkpoint_every_steps = 7
    cfg.time.integrator = integrator
    kw = dict(mesh=mesh, meshtags=tags, steps=30, return_state=True)
    _, u_c, v_c = planar3d_app.run(cfg, device="cpu", **kw)
    _zero_counts()
    out, u, v = planar3d_app.run(cfg, device="cuda", checkpoint_dir=str(tmp_path / "ck"),
                                 output=str(tmp_path / "out.xdmf"), **kw)
    chunks = -(-30 // 7)
    want = 4 * 31 if integrator == "rk4" else 30 + chunks + 2
    assert _launched() == {"K": want}
    assert "CUDA kernel K (csrc/general_kernels.cu)" in out["solver_path"]
    _assert_state_close(u.cpu(), v.cpu(), u_c, v_c)
    back = read_xdmf_attributes(str(tmp_path / "out.xdmf"))
    np.testing.assert_array_equal(back["u"], u.cpu().numpy())
    np.testing.assert_array_equal(back["v"], v.cpu().numpy())


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_cuda_general_solve_recording(cuda, integrator):
    """Recording on kernel K: the final state bitwise equal to solve_n's,
    the last row equal to u at the probes, the series within 1e-12 of the
    CPU's, K launched 4 per RK4 step (one per leapfrog step and one at
    t0)."""
    from wave_fenics_tpu_torch.models.general_wave import probe_dofs, solve_recording

    mesh, tags = perturbed_box((4, 3, 2))
    mg = GeneralLinearWave(mesh, 3, tags, dtype=F64, device=cuda)
    mc = GeneralLinearWave(mesh, 3, tags, dtype=F64, device="cpu")
    pts = np.asarray(mg.dofs.dof_coords)[[5, 77, 300]]
    dt = 0.5 * min_edge(mesh) / (1500.0 * 9) * (LEAPFROG_DT if integrator == "leapfrog" else 1.0)
    _zero_counts()
    u, v, s = solve_recording(mg, 0.0, dt, 20, pts, integrator=integrator)
    assert _launched() == {"K": 80 if integrator == "rk4" else 21}
    assert s.device.type == "cuda" and s.shape == (20, 3)
    ur, vr = mg.solve_n(0.0, dt, 20, integrator=integrator)
    assert torch.equal(u, ur) and torch.equal(v, vr)
    assert torch.equal(s[-1], u[torch.as_tensor(probe_dofs(mg, pts), device=cuda)])
    _, _, sc = solve_recording(mc, 0.0, dt, 20, pts, integrator=integrator)
    assert _rel(s.cpu(), sc) <= TOL


def test_cuda_linear_wave_solve_recording_and_energy(cuda):
    """Kernel F: the box model's recording (4 launches a step) within 1e-12
    of the CPU's; the energy of a box model (F) and of a general model (K)
    within 1e-12 of the CPU's."""
    from wave_fenics_tpu_torch.models import diagnostics
    from wave_fenics_tpu_torch.models.linear_wave import solve_recording

    mesh = box_mesh((6, 3, 3), (0.01, 0.005, 0.005), facet_tags=FacetTags({1: (0,), 2: (1,)}))
    mg, mc = (LinearWave(mesh, p=4, dtype=F64, device=d) for d in (cuda, "cpu"))
    pts = np.array([[0.002, 0.001, 0.002], [0.007, 0.004, 0.001]])
    _zero_counts()
    ug, vg, sg = solve_recording(mg, 0.0, DT, 25, pts)
    assert _launched() == {"F": 100}
    uc, vc, sc = solve_recording(mc, 0.0, DT, 25, pts)
    assert _rel(sg.cpu(), sc) <= TOL
    _assert_state_close(ug.cpu(), vg.cpu(), uc, vc)
    hm, tags = perturbed_box((4, 3, 2))
    gg, gc = (GeneralLinearWave(hm, 4, tags, dtype=F64, device=d) for d in (cuda, "cpu"))
    rng = np.random.default_rng(9)
    for mdl_g, mdl_c in ((mg, mc), (gg, gc)):
        shape = tuple(mdl_c.zero_state()[0].shape)
        u, v = rng.standard_normal(shape), rng.standard_normal(shape)
        e_c = float(diagnostics.energy(mdl_c, torch.as_tensor(u), torch.as_tensor(v)))
        e_g = float(diagnostics.energy(mdl_g, torch.as_tensor(u, device=cuda),
                                       torch.as_tensor(v, device=cuda)))
        assert abs(e_g - e_c) <= TOL * abs(e_c)


def test_cuda_box_output_on_kernel_a(cuda, tmp_path):
    """--output on the box branch (kernel A): the written fields equal
    pm.to_grid of the returned state, the node lines StructuredDofGrid's."""
    from wave_fenics_tpu_torch.core.dofmap import StructuredDofGrid
    from wave_fenics_tpu_torch.core.io import read_xdmf_attributes, read_xdmf_geometry

    _zero_counts()
    out, u, v = planar3d_app.run(cells=(4, 2, 2), dtype="f64", device="cuda", steps=6,
                                 output=str(tmp_path / "box.xdmf"), return_state=True)
    assert _launched() == {"A": 4 * 7} and out["output_seconds"] > 0
    case, pm = planar3d_app.build(cells=(4, 2, 2), dtype="f64", device="cuda")
    back = read_xdmf_attributes(str(tmp_path / "box.xdmf"))
    np.testing.assert_array_equal(back["u"], pm.to_grid(u).cpu().numpy())
    np.testing.assert_array_equal(back["v"], pm.to_grid(v).cpu().numpy())
    dg = StructuredDofGrid(case.model.mesh, case.model.p)
    z, y, x = read_xdmf_geometry(str(tmp_path / "box.xdmf"))
    for a, d in zip((x, y, z), range(3)):
        np.testing.assert_array_equal(a, dg.axis_coords(d))


# -- the general-model set-up on the card (native.py, csrc/setup_kernels.cu) --

SETUP_COUNTERS = {"geometry": "geometry_factors_cuda", "keys": "node_keys_cuda",
                  "dedup": "dedup_dofs_cuda"}


def _setup_counts():
    from wave_fenics_tpu_torch import native

    return {k: getattr(native, name).launches for k, name in SETUP_COUNTERS.items()}


def _clamp_decisions(G):
    G = np.asarray(G)
    return np.any([np.isclose(G, v, rtol=1e-5, atol=1e-8) for v in (-1.0, 0.0, 1.0)],
                  axis=0)


@pytest.mark.parametrize("p,q,rule", [(1, None, "gll"), (2, None, "gll"), (4, None, "gll"),
                                      (6, None, "gll"), (10, None, "gll"), (3, 8, "gauss")])
def test_cuda_geometry_factors_match_plain_and_numpy(cuda, p, q, rule):
    """geometry_factors_kernel (one launch) against its plain version (G
    within 1e-13 of max|G|, detJw within 1e-15 relative), against an
    80-bit extended-precision J (detJw within 1e-15) and against the NumPy
    route (G within 1e-13; its own detJw carries a few 1e-16 to 1e-15 more
    rounding, the J of absolute coordinates), clamped and not; no clamp
    decision differs. p = 10 (1,331 points) takes tiles of 128 points."""
    from wave_fenics_tpu_torch import native
    from wave_fenics_tpu_torch.core import geometry
    from wave_fenics_tpu_torch.core.basis import tabulate_1d

    mesh, _ = perturbed_box((4, 3, 2), h=0.25)
    tab = tabulate_1d(p, q, rule)
    _, dphi = geometry.trilinear_tabulate(geometry.quadrature_points_3d(tab))
    J = np.einsum("cni,jqn->cqij", mesh.cell_coords().astype(np.longdouble),
                  dphi.astype(np.longdouble))
    det = (J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
           - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
           + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]))
    exact = np.abs(det) * geometry.quadrature_weights_3d(tab).astype(np.longdouble)
    for clamp in (True, False):
        n0 = native.geometry_factors_cuda.launches
        G, dw = geometry.precompute_geometric_data(mesh, p, q, rule, clamp=clamp,
                                                   device=cuda)
        torch.cuda.synchronize()
        assert native.geometry_factors_cuda.launches == n0 + 1
        Gp, dwp = geometry.precompute_geometric_data(mesh, p, q, rule, clamp=clamp,
                                                     device="cpu")
        Gn, _ = geometry.precompute_geometric_data(mesh, p, q, rule, clamp=clamp)
        assert _rel(G.cpu(), Gp) <= 1e-13 and _rel(dw.cpu(), dwp) <= 1e-15
        assert _rel(G.cpu(), torch.as_tensor(Gn)) <= 1e-13
        err = np.abs(dw.cpu().numpy() - exact).max() / np.abs(exact).max()
        assert float(err) <= 1e-15
        if not clamp:
            assert int((_clamp_decisions(G.cpu()) != _clamp_decisions(Gn)).sum()) == 0


def test_cuda_geometry_singular_raises(cuda):
    from wave_fenics_tpu_torch.core import geometry
    from wave_fenics_tpu_torch.core.mesh import HexMesh

    hm = box_mesh((2, 1, 1), (1.0, 0.8, 0.9)).to_hex_mesh()
    pts = hm.points.copy()
    pts[:, 2] = 0.0
    with pytest.raises(ValueError, match="singular Jacobian in mesh"):
        geometry.precompute_geometric_data(HexMesh(points=pts, cells=hm.cells), 2,
                                           device=cuda)


@pytest.mark.parametrize("p", [1, 4, 10])
def test_cuda_node_keys_equal_plain_bitwise(cuda, p):
    """node_keys_kernel rounds each product and sum on its own, as its
    plain version does: keys and coordinates bit for bit."""
    from wave_fenics_tpu_torch import native

    mesh, _ = perturbed_box((5, 3, 2), h=0.002)
    cc = torch.as_tensor(mesh.cell_coords(), device=cuda)
    phi = torch.as_tensor(np.random.default_rng(p).random(((p + 1) ** 3, 8)), device=cuda)
    n0 = native.node_keys_cuda.launches
    keys, coords = native.node_keys(cc, phi, 1.0, 1e-9)
    assert native.node_keys_cuda.launches == n0 + 1
    kp, cp = native.node_keys_plain(cc, phi, 1.0, 1e-9)
    assert torch.equal(keys, kp) and torch.equal(coords, cp)
    kc, cpc = native.node_keys_plain(cc.cpu(), phi.cpu(), 1.0, 1e-9)
    assert torch.equal(keys.cpu(), kc) and torch.equal(coords.cpu(), cpc)


@pytest.mark.parametrize("p", [2, 4, 5])
def test_cuda_build_dofmap_one_dof_per_node_on_rotated_cells(cuda, p):
    """On cells that list their vertices in different orders, with shared
    nodes at a key's .5 boundary (``_torch_node_mesh.split_mesh``): the
    card's node keys and coordinates bit for bit the plain version's, and
    the card's dofmap the CPU routes', one dof per geometric node."""
    from _torch_node_mesh import expected_ndofs, one_dof_per_node, split_mesh

    from wave_fenics_tpu_torch import native
    from wave_fenics_tpu_torch.core.dofmap import node_phi
    from wave_fenics_tpu_torch.core.mesh import HexMesh

    pts, cells = split_mesh(p)
    cc = torch.as_tensor(pts[cells], device=cuda)
    phi = torch.as_tensor(node_phi(p), device=cuda)
    keys, coords = native.node_keys_cuda(cc, phi, 1.0, 1e-9)
    kp, cp = native.node_keys_plain(cc.cpu(), phi.cpu(), 1.0, 1e-9)
    assert torch.equal(keys.cpu(), kp) and torch.equal(coords.cpu(), cp)
    mesh = HexMesh(points=pts, cells=cells)
    got = build_dofmap(mesh, p, device=cuda)
    for ref in (build_dofmap(mesh, p, device="cpu"), build_dofmap(mesh, p)):
        assert got.ndofs == ref.ndofs == expected_ndofs(p)
        np.testing.assert_array_equal(got.dofmap, ref.dofmap)
    assert one_dof_per_node(got.dofmap, pts, cells, p)


@pytest.mark.parametrize("lo,hi,n", [(0, 6, 5000), (-3, 3, 200_000), (0, 100, 2_000_000),
                                     (-10**12, 10**12, 100_000)])
def test_cuda_dedup_matches_plain(cuda, lo, hi, n):
    """The hash dedup against its plain version: the same first-appearance
    ids, ndofs and first nodes; two runs bitwise equal."""
    from wave_fenics_tpu_torch import native

    keys = torch.as_tensor(np.random.default_rng(n).integers(lo, hi, size=(n, 3)),
                           device=cuda)
    ids, nd, first = native.dedup_dofs(keys, return_first=True)
    ids2, nd2 = native.dedup_dofs(keys)
    pids, pnd, pfirst = native.dedup_dofs_plain(keys, return_first=True)
    assert nd == nd2 == pnd and torch.equal(ids, ids2)
    assert torch.equal(ids, pids) and torch.equal(first, pfirst)


def test_cuda_dedup_rejects_bad_keys(cuda):
    from wave_fenics_tpu_torch import native

    with pytest.raises(TypeError):
        native.dedup_dofs(torch.zeros((4, 3), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        native.dedup_dofs(torch.zeros((4, 2), dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("reorder", ["appearance", "morton", None])
@pytest.mark.parametrize("p", [1, 2, 4, 5])
def test_cuda_build_dofmap_equals_numpy_route(cuda, p, reorder):
    mesh, _ = perturbed_box((6, 4, 3), h=0.002)
    got = build_dofmap(mesh, p, reorder=reorder, device=cuda)
    want = build_dofmap(mesh, p, reorder=reorder)
    assert got.ndofs == want.ndofs
    np.testing.assert_array_equal(got.dofmap, want.dofmap)
    np.testing.assert_array_equal(got.device_dofmap.cpu().numpy(), want.dofmap)
    assert _rel(torch.as_tensor(got.dof_coords), torch.as_tensor(want.dof_coords)) <= 1e-15


@pytest.mark.parametrize("quadrature", ["gll", "gauss"])
@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_cuda_general_wave_setup_matches_numpy_route(cuda, dtype, quadrature):
    """A model built on the card (its dofmap, geometry, affine test, lumped
    mass and facet weights there: each set-up kernel launched, one dedup a
    tag) against the NumPy route: dofmap equal, m, W1, W2 within 1e-12
    (f64) or 1e-6 (f32) relative, K's tables within the same."""
    from wave_fenics_tpu_torch.models.general_wave import facet_lumped_weights

    mesh, tags = perturbed_box((6, 4, 3), h=0.002)
    tol = 1e-12 if dtype == F64 else 1e-6
    c0 = _setup_counts()
    mg = GeneralLinearWave(mesh, 3, tags, dtype=dtype, device=cuda, quadrature=quadrature)
    counts = {k: n - c0[k] for k, n in _setup_counts().items()}
    assert counts == {"geometry": 1, "keys": 1, "dedup": 3}
    dofs = build_dofmap(mesh, 3)
    ops = GeneralOperators(mesh, dofs, dtype=dtype, rule=quadrature)
    np.testing.assert_array_equal(mg.dofs.dofmap, dofs.dofmap)
    assert mg.ops.affine == ops.affine
    assert _rel(mg.m.cpu(), torch.as_tensor(ops.lumped_mass)) <= tol
    for name, tag in (("W1", 1), ("W2", 2)):
        W = facet_lumped_weights(mesh, dofs, tags[tag], 3, rule=quadrature)
        assert _rel(getattr(mg, name).cpu().double(), torch.as_tensor(W)) <= tol
    mode = "stiffness" if quadrature == "gll" else "stiffness_gauss"
    t, r = mg.ops.tables(mode, cuda), ops.tables(mode, cuda)
    assert _rel(t.geo, r.geo) <= tol and torch.equal(t.dofmap, r.dofmap)


def test_cuda_two_setups_are_bitwise_equal(cuda):
    """No float atomics in the set-up: two builds of one model agree bit
    for bit (dofmap, dof coordinates, G, detJw, m, W1, W2)."""
    mesh, tags = perturbed_box((6, 4, 3), h=0.002)
    a, b = (GeneralLinearWave(mesh, 4, tags, dtype=torch.float32, device=cuda)
            for _ in range(2))
    np.testing.assert_array_equal(a.dofs.dofmap, b.dofs.dofmap)
    np.testing.assert_array_equal(a.dofs.dof_coords, b.dofs.dof_coords)
    for name in ("m", "W1", "W2"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(a.ops._G, b.ops._G) and torch.equal(a.ops._detJw, b.ops._detJw)


def test_cuda_unmatched_facet_raises(cuda):
    from wave_fenics_tpu_torch.models.general_wave import facet_lumped_weights

    mesh, tags = perturbed_box((3, 2, 2), h=0.25)
    bad = tags[1][:1].copy()
    bad[0, 3] = mesh.cells[-1, 7]
    with pytest.raises(ValueError, match="does not coincide with a volume dof"):
        facet_lumped_weights(mesh, build_dofmap(mesh, 2, device=cuda), bad, 2, device=cuda)


# -- the distributed structured box (parallel/) ------------------------------

def _sharded(p, device, parts, shape=(4, 2, 2), kernel="flat", dtype=F64):
    from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave

    mesh = box_mesh(shape, (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    return ShardedPaddedWave(LinearWave(mesh, p=p, dtype=dtype, device=device), parts,
                             kernel=kernel)


def _halo_state(sw, lay, seed, scale=1.0):
    """Random global fields in the blocks of ``lay``, their value halos
    refreshed: what a kernel call of a value-halo path reads."""
    rng = np.random.default_rng(seed)
    shape = tuple(n * sw.model.p + 1 for n in sw.model.mesh.shape)
    u = sw.refresh(sw.from_global(rng.standard_normal(shape), lay), lay)
    v = sw.refresh(sw.from_global(scale * rng.standard_normal(shape), lay), lay)
    return u, v


def _outside_box_zero(lay, ring, *fields):
    x0, nx, h, ny, nz = lay.box(ring)
    for x in fields:
        outside = x.clone()
        outside[x0 : x0 + nx, h : h + ny, h : h + nz] = 0.0
        assert float(outside.abs().max()) == 0.0


# (path, p, the output rings of the call's u and v)
HALO_CASES = [("step", 2, (0, 0)), ("step", 4, (0, 0)), ("lf", 2, (2, 0)),
              ("lf", 4, (4, 0)), ("lf2", 2, (2, 0)), ("lf2", 4, (4, 0))]


@pytest.mark.parametrize("path,p,rings", HALO_CASES)
def test_cuda_halo_layout_kernels_match_plain_over_nan(cuda, path, p, rings):
    """Kernels A, H and I on the value-halo layouts (3p, 2p, 3p), one call
    on each block of a (2,2,1) split from output and scratch buffers full
    of NaN: the interior against the plain version at 1e-12, the outputs
    exactly 0 outside their ring, nothing left NaN."""
    sw = _sharded(p, cuda, (2, 2, 1))
    lay = sw.halo_layout(path)
    u0, v0 = _halo_state(sw, lay, 51, scale=1e3)
    counter = {"step": rk4step.rk4_step_lean_cuda, "lf": lfstep.lf_step_cuda,
               "lf2": lf2step.lf2_step_cuda}[path]
    inter = lay.interior
    for b, (tables, st, src_x, abc_x) in enumerate(sw._halo_tables(path)):
        nan = [torch.full_like(u0[b], float("nan")) for _ in range(5)]
        n0 = counter.launches
        if path == "step":
            gs = GS
            uk, vk = rk4step.rk4_step_lean(u0[b], v0[b], DT, gs, lay, sw.model.c0,
                                           tables, st, src_x, abc_x,
                                           out=tuple(nan[:2]), scratch=tuple(nan[2:]))
            up, vp = rk4step.rk4_step_lean_plain(u0[b], v0[b], DT, gs, lay, sw.model.c0,
                                                 tables)
            calls = 4
        elif path == "lf":
            uk, vk = lfstep.lf_step(u0[b], v0[b], DT, 1.0, 0.6, lay, sw.model.c0, tables,
                                    st, src_x, abc_x, out=tuple(nan[:2]), scratch=nan[2])
            up, vp = lfstep.lf_step_plain(u0[b], v0[b], DT, 1.0, 0.6, lay, sw.model.c0,
                                          tables)
            calls = 2
            nan = nan[:3]  # two outputs and one scratch field
        else:
            uk, vk = lf2step.lf2_step(u0[b], v0[b], DT, 1.0, 0.6, 0.2, lay, sw.model.c0,
                                      tables, st, src_x, abc_x, out=tuple(nan[:2]),
                                      scratch=tuple(nan[2:]))
            up, vp = lf2step.lf2_step_plain(u0[b], v0[b], DT, 1.0, 0.6, 0.2, lay,
                                            sw.model.c0, tables)
            calls = 3
        torch.cuda.synchronize()
        assert counter.launches == n0 + calls
        assert not any(bool(torch.isnan(x).any()) for x in nan)
        _assert_state_close(uk[inter], vk[inter], up[inter], vp[inter])
        _outside_box_zero(lay, rings[0], uk)
        _outside_box_zero(lay, rings[1], vk)


@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("lean", [True, False])
def test_cuda_halo_layout_step_kernels_every_p_over_nan(cuda, lean, p):
    """Kernels A and C on the 3p value-halo layout of a (2,1,1) split at
    every p: stages 0 and 1 on the interior grown p into the halo, each
    stage's TMA windows reading the p-deep ring of halo values around its
    box; from buffers full of NaN, the interior against the plain version
    at 1e-12, kv0 and kv1 exactly 0 beyond their ring, kv2, u1 and v1
    beyond the interior, nothing left NaN."""
    sw = _sharded(p, cuda, (2, 1, 1))
    lay = sw.halo_layout("step")
    u0, v0 = _halo_state(sw, lay, 70 + p, scale=1e3)
    step = rk4step.rk4_step_lean if lean else rk4step.rk4_step_full
    plain = rk4step.rk4_step_lean_plain if lean else rk4step.rk4_step_full_plain
    inter = lay.interior
    for b, (tables, st, src_x, abc_x) in enumerate(sw._halo_tables("step")):
        nan = [torch.full_like(u0[b], float("nan")) for _ in range(5)]
        uk, vk = step(u0[b], v0[b], DT, GS, lay, sw.model.c0, tables, st, src_x, abc_x,
                      out=tuple(nan[:2]), scratch=tuple(nan[2:]))
        up, vp = plain(u0[b], v0[b], DT, GS, lay, sw.model.c0, tables)
        torch.cuda.synchronize()
        assert not any(bool(torch.isnan(x).any()) for x in nan)
        _assert_state_close(uk[inter], vk[inter], up[inter], vp[inter])
        _outside_box_zero(lay, p, nan[2], nan[3])
        _outside_box_zero(lay, 0, uk, vk, nan[4])


@pytest.mark.parametrize("parts", [(2, 1, 1), (2, 2, 1)])
@pytest.mark.parametrize("path", ["n", "n3d", "step", "lf", "lf2"])
def test_cuda_sharded_solves_match_single_device(cuda, path, parts):
    """Every sharded structured path on the card (B, E, A, H, I on each
    block) against the single-device solve of the same path on the card,
    f64, 12 steps, at 1e-12; each kernel launched once per block per launch
    of a step."""
    sw = _sharded(4, cuda, parts, kernel="3d" if path == "n3d" else "flat")
    pm = PaddedLinearWave(sw.model, tile_x=16, kernel="3d" if path == "n3d" else "flat")
    nb, n = sw.mesh.nblocks, 12
    solve, ref, counter, per_step, conv = {
        "n": (sw.solve_n, pm.solve_n, wave.apply_flat_cuda, 4, sw.to_global),
        "n3d": (sw.solve_n, pm.solve_n, wave.apply_slab_cuda, 4, sw.to_global),
        "step": (sw.solve_step_n, pm.solve_step_n, rk4step.rk4_step_lean_cuda, 4,
                 sw.to_global_step),
        "lf": (sw.solve_lf_n, pm.solve_lf_n, lfstep.lf_step_cuda, 2, sw.to_global_lf),
        "lf2": (sw.solve_lf2_n, pm.solve_lf2_n, lf2step.lf2_step_cuda, 1.5,
                sw.to_global_lf2),
    }[path]
    n0 = counter.launches
    u, v = solve(0.0, DT, n)[:2]
    torch.cuda.synchronize()
    assert counter.launches == n0 + int(per_step * n) * nb
    ur, vr = ref(0.0, DT, n)[:2]
    _assert_state_close(torch.as_tensor(conv(u)), torch.as_tensor(conv(v)),
                        pm.to_grid(ur).cpu(), pm.to_grid(vr).cpu())


def test_cuda_sharded_step_interface_planes_bitwise(cuda):
    """After the value-halo refresh the duplicated x-interface plane holds
    the lower block's value on both blocks, bit for bit."""
    sw = _sharded(4, cuda, (2, 2, 1))
    lay = sw.halo_layout("step")
    u, v, _ = sw.solve_step_n(0.0, DT, 8)
    sw.refresh(v, lay)
    x0, nx = lay.x0, lay.shape[0]
    for by in range(2):
        lo, hi = v[sw.mesh.index(0, by, 0)], v[sw.mesh.index(1, by, 0)]
        assert torch.equal(lo[lay.interior][-1], hi[lay.interior][0])
    assert float(v[0][x0 + nx - 1].abs().max()) > 0.0


def test_cuda_sharded_linear_wave_and_cg_match_cpu(cuda):
    """ShardedLinearWave on kernel F per block: the solve and the
    distributed CG mass solve on the card against the CPU's, f64."""
    from wave_fenics_tpu_torch.parallel.sharded_wave import ShardedLinearWave

    mesh = box_mesh((4, 2, 2), (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    sws = [ShardedLinearWave(LinearWave(mesh, p=4, dtype=F64, device=d), (2, 2, 1))
           for d in ("cpu", cuda)]
    n0 = stiffness.stiffness_grid_cuda.launches
    (uc, vc, _), (ug, vg, _) = (s.solve_n(0.0, DT, 10) for s in sws)
    assert stiffness.stiffness_grid_cuda.launches == n0 + 4 * 10 * 4
    _assert_state_close(torch.as_tensor(sws[1].to_global(ug)),
                        torch.as_tensor(sws[1].to_global(vg)),
                        torch.as_tensor(sws[0].to_global(uc)),
                        torch.as_tensor(sws[0].to_global(vc)))
    b = np.random.default_rng(52).standard_normal(tuple(n * 4 + 1 for n in mesh.shape))
    (xc, kc, _), (xg, kg, _) = (s.cg_mass(s.from_global(b), kmax=60, rtol=1e-10)
                                for s in sws)
    assert kc == kg
    # the two dots sum in different orders, which CG amplifies: both
    # solutions agree with x = b / m (the assembled lumped mass) to CG's
    # tolerance
    exact = torch.as_tensor(b / sws[0].model.ops.lumped_mass)
    for s, x in zip(sws, (xc, xg)):
        assert _rel(torch.as_tensor(s.to_global(x)), exact) <= 1e-9


@pytest.mark.parametrize("integrator,kernel,per_step", [("rk4", "A", 4),
                                                         ("leapfrog", "H", 2)])
def test_cuda_app_ndev_runs_the_sharded_kernels(cuda, tmp_path, integrator, kernel,
                                               per_step):
    """The app's --ndev 4 on the card: the JAX app's solver_path, the value-
    halo kernel launched once per block per launch of a step (the warm-up
    step included), and the final global grid (--output) the CPU run's."""
    from wave_fenics_tpu_torch.core.io import read_xdmf_attributes

    counter = {"A": rk4step.rk4_step_lean_cuda, "H": lfstep.lf_step_cuda}[kernel]
    kw = dict(cells=(8, 4, 4), degree=4, dtype="f64", steps=6, integrator=integrator,
              ndev=4)
    n0 = counter.launches
    out = planar3d_app.run(device="cuda", output=str(tmp_path / "g.xdmf"), **kw)
    assert counter.launches == n0 + per_step * (6 + 1) * 4
    assert out["solver_path"] == ("sharded value-halo RK4 STEP kernel" if integrator == "rk4"
                                  else "sharded value-halo leapfrog STEP kernel")
    planar3d_app.run(device="cpu", output=str(tmp_path / "c.xdmf"), **kw)
    g, c = (read_xdmf_attributes(str(tmp_path / f)) for f in ("g.xdmf", "c.xdmf"))
    _assert_state_close(torch.as_tensor(g["u"]), torch.as_tensor(g["v"]),
                        torch.as_tensor(c["u"]), torch.as_tensor(c["v"]))


# -- the distributed imported mesh (parallel/sharded_general.py) -------------

def _sharded_general_pair(device, ndev=4, p=3, exchange="auto"):
    """(ShardedGeneralWave on the CPU, on ``device``) of one perturbed-box
    model in f64."""
    from wave_fenics_tpu_torch.parallel.sharded_general import ShardedGeneralWave

    hm, tags = perturbed_box((6, 4, 4), h=0.002)
    return [ShardedGeneralWave(GeneralLinearWave(hm, p, tags, dtype=F64, device=d), ndev,
                               exchange=exchange) for d in ("cpu", device)]


@pytest.mark.parametrize("p", [2, 4])
def test_cuda_sharded_general_k_per_part_matches_plain_over_nan(cuda, p):
    """Kernel K on each part's own tables (local dofmap and colouring, the
    model's geometry sliced to the part's cells), from an output full of
    NaN, against its plain version at 1e-12; two applies bitwise equal; the
    affine box takes the affine branch on every part as on the whole."""
    from wave_fenics_tpu_torch.parallel.sharded_general import ShardedGeneralWave

    hm, tags = perturbed_box((6, 4, 4), h=0.002)
    box = box_mesh((6, 4, 4), (0.012, 0.008, 0.008)).to_hex_mesh()
    for mesh, affine in ((hm, False), (box, True)):
        model = GeneralLinearWave(mesh, p, tags if mesh is hm else {}, dtype=F64,
                                  device=cuda)
        sw = ShardedGeneralWave(model, 4)
        assert model.ops.affine == affine
        for i, t in sw._tables["K"].items():
            assert t.affine == affine and t.dofmap.device.type == "cuda"
            x = torch.as_tensor(np.random.default_rng(90 + i).standard_normal(t.ndofs),
                                dtype=F64, device=cuda)
            out = torch.full_like(x, float("nan"))
            yk = general.general_apply_cuda(x, t, -1500.0**2, out=out)
            yk2 = general.general_apply_cuda(x, t, -1500.0**2)
            yp = general.general_apply_plain(x, t, -1500.0**2)
            assert _rel(yk, yp) <= TOL and torch.equal(yk, yk2)


@pytest.mark.parametrize("integrator,exchange", [("rk4", "allgather"), ("rk4", "ppermute"),
                                                 ("leapfrog", "auto")])
def test_cuda_sharded_general_solves_match_cpu(cuda, integrator, exchange):
    """The sharded RK4 and leapfrog solves on kernel K per part against the
    CPU's (f64, 4 parts, 10 steps) at 1e-12; K launched once per part per
    stiffness apply and no other kernel."""
    sc, sg = _sharded_general_pair(cuda, exchange=exchange)
    uc, vc, _ = sc.solve_n(0.0, DT, 10, integrator=integrator)
    _zero_counts()
    ug, vg, _ = sg.solve_n(0.0, DT, 10, integrator=integrator)
    torch.cuda.synchronize()
    assert _launched() == {"K": 4 * (4 * 10 if integrator == "rk4" else 10 + 1)}
    _assert_state_close(*(torch.as_tensor(s.to_global(x))
                          for s, x in ((sg, ug), (sg, vg), (sc, uc), (sc, vc))))


def test_cuda_sharded_general_cg_matches_cpu(cuda):
    """cg_solve on the card against the CPU's: iterations equal, x at
    1e-10 relative (the dots sum in another order)."""
    sc, sg = _sharded_general_pair(cuda, p=4, exchange="ppermute")
    b = np.random.default_rng(53).standard_normal(sc.model.ndofs)
    tau = (0.25 * 0.002 / (1500.0 * 16)) ** 2
    (xc, kc, _), (xg, kg, _) = (s.cg_solve(s.from_global(b), tau, kmax=80, rtol=1e-10)
                                for s in (sc, sg))
    assert kc == kg and 0 < kg < 80
    assert _rel(torch.as_tensor(sg.to_global(xg)), torch.as_tensor(sc.to_global(xc))) <= 1e-10


def test_cuda_app_mesh_ndev_matches_cpu(cuda, tmp_path):
    """The app's --mesh --ndev 2 on the card: the JAX app's solver_path, K
    launched 2 parts x 4 x (steps + 1 warm-up step), and the final state
    (--output, the global vector) the CPU run's."""
    from wave_fenics_tpu_torch.core.io import read_xdmf_attributes

    mesh, tags = _imported_files(tmp_path)
    kw = dict(mesh=mesh, meshtags=tags, degree=3, dtype="f64", steps=12, ndev=2)
    _zero_counts()
    out = planar3d_app.run(device="cuda", output=str(tmp_path / "g.xdmf"), **kw)
    assert _launched() == {"K": 2 * 4 * (12 + 1)}
    assert out["solver_path"] == "sharded general (rk4, RCB, ndev=2)"
    planar3d_app.run(device="cpu", output=str(tmp_path / "c.xdmf"), **kw)
    g, c = (read_xdmf_attributes(str(tmp_path / f)) for f in ("g.xdmf", "c.xdmf"))
    _assert_state_close(torch.as_tensor(g["u"]), torch.as_tensor(g["v"]),
                        torch.as_tensor(c["u"]), torch.as_tensor(c["v"]))


# -- the distributed 2-step RK4 (kernel J on the 6p value halo), Newmark on
# kernel F, the heterogeneous box, the element-assembly operator ----------

def _step2_state(sw, seed, dtype=F64):
    """Random O(1) u and 1e3-scaled v on the blocks of the 6p layout, their
    halos refreshed, and random kv0..kv2 over the whole 6p halo (what the
    boundary launch reads as it is in memory)."""
    lay = sw.halo_layout("step2")
    u, v = _halo_state(sw, lay, seed, scale=1e3)
    kvs = [_halo_state(sw, lay, seed + 10 + j, scale=1e9)[0] for j in range(3)]
    cast = lambda bl: [x.to(dtype) for x in bl]  # noqa: E731
    return lay, cast(u), cast(v), [cast(k) for k in kvs]


@pytest.mark.parametrize("dtype,tol", [(F64, TOL), (torch.float32, 1e-5)])
@pytest.mark.parametrize("p", [3, 4, 5])
def test_cuda_rk42_boundary_grown_box_matches_plain_over_nan(cuda, p, dtype, tol):
    """J's step boundary on its grown launch box (the interior + 2p of the
    6p value halo) from outputs full of NaN, on each block of (4,2,2) cells
    on (2,1,1): block 0's box holds the global x-high face row and block
    1's the x-low one, both in the halo. Against rk42_boundary_plain on the
    same box, per field relative to max|ref|, every point of the state; 0
    outside the box."""
    sw = _sharded(p, cuda, (2, 1, 1), dtype=dtype)
    lay, u, v, kvs = _step2_state(sw, 70 + p, dtype)
    ring = rk42step.call_rings(lay)[0][3]
    assert ring == 2 * p
    x0, nx, _, _, _ = lay.box(ring)
    for b, (faces, st, src_x, abc_x) in enumerate(sw._halo_tables("step2")):
        face_rows = [r for r in (src_x, abc_x) if r >= 0]
        assert any(not (lay.x0 <= r < lay.x0 + lay.shape[0]) and x0 <= r < x0 + nx
                   for r in face_rows), "a face row in the halo, inside the box"
        ins = (u[b], v[b], *(k[b] for k in kvs))
        args = (DT, 0.5, lay, sw.model.c0, st, *faces, src_x, abc_x)
        out = tuple(torch.full_like(ins[0], float("nan")) for _ in range(3))
        got = rk42step._rk42_boundary_cuda(*ins, *args, out=out, ring=ring)
        torch.cuda.synchronize()
        want = rk42step.rk42_boundary_plain(*ins, *args, ring=ring)
        for x, w in zip(got, want):
            assert _rel(x, w) <= tol
        _outside_box_zero(lay, ring, *got)


@pytest.mark.parametrize("cells,parts", [((4, 2, 2), (2, 1, 1)), ((8, 4, 4), (2, 2, 1))])
def test_cuda_rk42_call_on_the_6p_halo_matches_plain_over_nan(cuda, cells, parts):
    """One kernel-J call (seven launches, each on its ring) on every block
    of the 6p layout from output and scratch buffers full of NaN, against
    rk42_step_plain on the same rings, at every point of the state."""
    sw = _sharded(4, cuda, parts, shape=cells)
    lay, u, v, _ = _step2_state(sw, 90)
    for b, (faces, st, src_x, abc_x) in enumerate(sw._halo_tables("step2")):
        nan = [torch.full_like(u[b], float("nan")) for _ in range(8)]
        n0 = rk42step.rk42_step_cuda.launches
        args = (DT, (1.0, 0.8, 0.55, 0.3, 0.1), lay, sw.model.c0, st, *faces, src_x,
                abc_x)
        uk, vk = rk42step.rk42_step_cuda(u[b], v[b], *args, out=tuple(nan[:2]),
                                         scratch=tuple(nan[2:]))
        torch.cuda.synchronize()
        assert rk42step.rk42_step_cuda.launches == n0 + 7
        up, vp = rk42step.rk42_step_plain(u[b], v[b], *args)
        _assert_state_close(uk, vk, up, vp)
        _outside_box_zero(lay, 0, uk, vk)
        assert not any(bool(torch.isnan(x).any()) for x in nan)


@pytest.mark.parametrize("cells,parts", [((8, 4, 4), (2, 2, 1)), ((15, 4, 4), (3, 1, 1))])
def test_cuda_sharded_step2_matches_single_device(cuda, cells, parts):
    """solve_step2_n on the card from a random O(1) state against the
    one-device solve_step_n on the card, f64, 12 steps, at 1e-12; kernel J
    launched 7 times per block per call."""
    sw = _sharded(4, cuda, parts, shape=cells)
    pm = PaddedLinearWave(sw.model, tile_x=24)
    lay = sw.halo_layout("step2")
    rng = np.random.default_rng(3)
    g = tuple(n * 4 + 1 for n in cells)
    u0, v0 = rng.standard_normal(g), rng.standard_normal(g)
    n0 = rk42step.rk42_step_cuda.launches
    u, v, _ = sw.solve_step2_n(0.0, DT, 12, sw.from_global(u0, lay),
                               sw.from_global(v0, lay))
    torch.cuda.synchronize()
    assert rk42step.rk42_step_cuda.launches == n0 + 7 * 6 * sw.mesh.nblocks
    ur, vr, _ = pm.solve_step_n(0.0, DT, 12, pm.from_grid(torch.as_tensor(u0, device=cuda)),
                                pm.from_grid(torch.as_tensor(v0, device=cuda)))
    _assert_state_close(torch.as_tensor(sw.to_global_step2(u)),
                        torch.as_tensor(sw.to_global_step2(v)),
                        pm.to_grid(ur).cpu(), pm.to_grid(vr).cpu())


def test_cuda_newmark_on_kernel_f_matches_cpu(cuda):
    """newmark_solve_n on the card: kernel F once per right-hand side and
    once per CG matvec (the start's residual and each iteration), once more
    for the initial acceleration; (u, v, a) against the CPU solve, where CG
    may stop one iteration apart, within 1e-8."""
    from wave_fenics_tpu_torch.solvers.newmark import newmark_solve_n

    mesh = box_mesh((6, 2, 2), (1.0, 0.3, 0.3), facet_tags=FacetTags({1: (0,), 2: (1,)}))
    res = []
    for device in ("cpu", cuda):
        m = LinearWave(mesh, p=3, c0=1.0, dtype=F64, device=device)
        x = torch.as_tensor(np.sin(np.linspace(0, np.pi, 19))[:, None, None]
                            * np.ones(m.ops.grid_shape), device=device)
        stats = {}
        n0 = stiffness.stiffness_grid_cuda.launches
        out = newmark_solve_n(m, 0.02, 20, x, torch.zeros_like(x), t0=1e-3, stats=stats)
        res.append((out, stats, stiffness.stiffness_grid_cuda.launches - n0))
    (cpu_out, cpu_stats, cpu_f), (gpu_out, gpu_stats, gpu_f) = res
    assert cpu_f == 0
    assert gpu_f == sum(gpu_stats["cg_iterations"]) + 2 * 20 + 1
    assert all(abs(a - b) <= 1 for a, b in zip(cpu_stats["cg_iterations"],
                                                gpu_stats["cg_iterations"]))
    for g, c in zip(gpu_out, cpu_out):
        assert _rel(g.cpu(), c) <= 1e-8


def test_cuda_heterogeneous_box_matches_cpu(cuda):
    """LinearWave(c0_cells) on the card (the per-cell stiffness, plain
    torch on every device; no kernel) against the CPU, f64, 25 RK4 steps."""
    mesh = box_mesh((4, 2, 2), (1.0, 0.5, 0.5), facet_tags=FacetTags({1: (0,), 2: (1,)}))
    c0_cells = np.where(np.arange(16) // 4 < 2, 1.0, 1.3)
    out = []
    for device in ("cpu", cuda):
        m = LinearWave(mesh, p=3, c0=1.0, dtype=F64, device=device, c0_cells=c0_cells)
        n0 = stiffness.stiffness_grid_cuda.launches
        u, v, _ = m.solve(0.0, 25e-3, 1e-3, *m.zero_state())
        assert stiffness.stiffness_grid_cuda.launches == n0
        out.append((u.cpu(), v.cpu()))
    _assert_state_close(*out[1], *out[0])


def test_cuda_ea_matches_kernel_k(cuda):
    """EAOperator on the card (the batched product of the stored A_e, on
    the clamped geometry, so it is kernel K's operator) against kernel K's
    stiffness, f64, on a perturbed box at p = 3."""
    from wave_fenics_tpu_torch.ops.assembled import EAOperator, assemble_element_tensors

    hm, _ = perturbed_box((3, 3, 2), h=0.01)
    dofs = build_dofmap(hm, 3)
    ea = EAOperator(dofs, assemble_element_tensors(hm, 3, kind="stiffness", coeff=-2.0,
                                                   clamp=True), dtype=F64, device=cuda)
    ops = GeneralOperators(hm, dofs, dtype=F64)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(dofs.ndofs), device=cuda)
    n0 = general.general_apply_cuda.launches
    want = ops.stiffness(x, 2.0**0.5)
    assert general.general_apply_cuda.launches == n0 + 1
    assert _rel(ea(x), want) <= TOL


# -- bf16 state: kernels A, C, B, D and F against their plain bf16 twins ------
BF16 = torch.bfloat16
ONE_BF16 = 1e-2  # one step, stage or apply: max|err| / max|ref|, about 2 ulps


def _bf16_model(p, device, shape=(4, 2, 2), lean=True):
    mesh = box_mesh(shape, (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    return PaddedLinearWave(LinearWave(mesh, p=p, dtype=BF16, device=device),
                            tile_x=max(16, rk4step._off0(p)), lean=lean)


def _bf16_state(layout, seed, device, scale=1.0):
    x = np.zeros(layout.padded_shape)
    x[layout.interior] = scale * np.random.default_rng(seed).standard_normal(layout.shape)
    return torch.as_tensor(x, device=device).to(BF16)


def _bf16_rel(got, want) -> float:
    return float((got.double().cpu() - want.double().cpu()).abs().max()
                 / want.double().abs().max())


def _bf16_padding_zero(layout, x):
    outside = x.clone()
    outside[layout.interior] = 0
    return float(outside.abs().max()) == 0.0 and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("kernel,p,shape", [
    ("A", 2, (4, 2, 2)), ("A", 4, (4, 2, 2)), ("A", 4, (9, 4, 8)),
    ("C", 2, (4, 2, 2)), ("C", 4, (4, 2, 2))])
def test_bf16_step_kernel_matches_plain_twin(cuda, kernel, p, shape):
    """One bf16 step of kernel A (C) from NaN in every buffer against the
    plain twin on the CPU; then 25 steps within 1.5x the plain twin's own
    error against the plain f64 run from the same state."""
    lean = kernel == "A"
    pm, pc = _bf16_model(p, cuda, shape, lean), _bf16_model(p, "cpu", shape, lean)
    u0, v0 = _bf16_state(pm.layout, p, cuda), _bf16_state(pm.layout, p + 1, cuda, 1e3)
    pairs, scratch = pm._workspace()
    for x in (*pairs[0], *pairs[1], *scratch):
        x.fill_(float("nan"))
    u, v, _ = pm.solve_step_n(0.0, DT, 1, u0, v0)
    up, vp, _ = pc.solve_step_n(0.0, DT, 1, u0.cpu(), v0.cpu())
    torch.cuda.synchronize()
    assert _bf16_rel(u, up) <= ONE_BF16 and _bf16_rel(v, vp) <= ONE_BF16
    assert all(_bf16_padding_zero(pm.layout, x) for x in (u, v, *scratch[:3]))
    mesh = pc.base.mesh
    p64 = PaddedLinearWave(LinearWave(mesh, p=p, dtype=F64, device="cpu"),
                           tile_x=pc.layout.tile_x, lean=lean)
    ref = p64.solve_step_n(0.0, DT, 25, u0.double().cpu(), v0.double().cpu())[:2]
    kern = pm.solve_step_n(0.0, DT, 25, u0, v0)[:2]
    plain = pc.solve_step_n(0.0, DT, 25, u0.cpu(), v0.cpu())[:2]
    e_k = max(_bf16_rel(k, r) for k, r in zip(kern, ref))
    e_p = max(_bf16_rel(k, r) for k, r in zip(plain, ref))
    assert e_k <= 1.5 * e_p


@pytest.mark.parametrize("p", [4, 8])
def test_bf16_stage_kernel_matches_plain_twin(cuda, p):
    """One bf16 stage of kernel D from outputs full of NaN against the
    plain twin: all four outputs, the padding exactly 0."""
    pm, pc = _bf16_model(p, cuda), _bf16_model(p, "cpu")
    ins = [_bf16_state(pm.layout, 10 * p + i, cuda, 1e3 if i % 2 else 1.0)
           for i in range(6)]
    args = (0.5 * DT, DT / 3.0, 1.0, pm.layout, pm.base.c0)
    nan = tuple(torch.full_like(ins[0], float("nan")) for _ in range(4))
    got = wave.rk_stage_cuda(*ins, *args, pm.stencil, pm.face_w1, pm.face_w2,
                             pm.src_x, pm.abc_x, out=nan)
    want = wave.rk_stage_plain(*(x.cpu() for x in ins), *args, pc.flat_tables,
                               pc.face_w1, pc.face_w2, pc.src_x, pc.abc_x)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _bf16_rel(g, w) <= ONE_BF16 and _bf16_padding_zero(pm.layout, g)


@pytest.mark.parametrize("p", [2, 4])
def test_bf16_flat_and_stiffness_kernels_match_plain_twins(cuda, p):
    """One bf16 apply of kernel B (from NaN, the padding exactly 0) and of
    kernel F (from NaN, every grid point written) against their plain
    twins."""
    pm, pc = _bf16_model(p, cuda), _bf16_model(p, "cpu")
    x = _bf16_state(pm.layout, 40 + p, cuda)
    y = wave.apply_flat_cuda(x, pm.layout, pm.stencil,
                             out=torch.full_like(x, float("nan")))
    want = wave.apply_flat_plain(x.cpu(), pc.layout, pc.flat_tables)
    torch.cuda.synchronize()
    assert _bf16_rel(y, want) <= ONE_BF16 and _bf16_padding_zero(pm.layout, y)
    ops = pm.base.ops
    tabs = stiffness.GridStiffnessTables(*ops._tensors(
        ("stiffness", -1500.0**2), cuda, lambda: stiffness.stiffness_grid_tables(
            ops._sepA, ops._seplines, ops.grid_shape, p, -1500.0**2, BF16)))
    g = torch.as_tensor(np.random.default_rng(50 + p).standard_normal(ops.grid_shape),
                        device=cuda).to(BF16)
    yk = stiffness.stiffness_grid_cuda(g, tabs, p, out=torch.full_like(g, float("nan")))
    yp = stiffness.stiffness_grid_plain(g, tabs, p)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(yk).all()) and _bf16_rel(yk, yp) <= ONE_BF16


@pytest.mark.parametrize("cells,p", [((9, 8, 8), 4), ((9, 8, 8), 3), ((5, 7, 11), 3)])
def test_bf16_stiffness_kernel_on_several_tiles(cuda, cells, p):
    """One bf16 apply of kernel F from NaN on a grid of several y and z
    tiles and x chunks, so that tiles start away from 0 and each plane's
    window shifts by the parity of its global start, against the plain
    twin: every point written, within two ulps of max|ref|."""
    shape = tuple(n * p + 1 for n in cells)
    grid, *_ = tiling.grid_geometry(shape, p, 2)
    assert min(grid) >= 1 and max(grid[:2]) >= 2
    ops = StructuredOperators(box_mesh(cells, (0.01, 0.008, 0.008)), p, dtype=BF16)
    tabs = stiffness.GridStiffnessTables(*ops._tensors(
        ("stiffness", -1500.0**2), cuda, lambda: stiffness.stiffness_grid_tables(
            ops._sepA, ops._seplines, ops.grid_shape, p, -1500.0**2, BF16)))
    g = torch.as_tensor(np.random.default_rng(60 + p).standard_normal(ops.grid_shape),
                        device=cuda).to(BF16)
    yk = stiffness.stiffness_grid_cuda(g, tabs, p, out=torch.full_like(g, float("nan")))
    yp = stiffness.stiffness_grid_plain(g, tabs, p)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(yk).all()) and _bf16_rel(yk, yp) <= ONE_BF16


# -- bf16 state: kernels H, I, J and E against their plain bf16 twins ---------
# grids of several y and z tiles and x chunks (tiling.tma_geometry at 2
# bytes a value: two or three z tiles of 24, two or three y tiles)
BF16_TILED_CELLS = {1: (8, 10, 40), 3: (4, 4, 12), 4: (4, 3, 9), 8: (3, 2, 5)}


def _bf16_tiled_model(p, device, tile_x, shape=None, kernel="flat"):
    mesh = box_mesh(shape or BF16_TILED_CELLS[p], (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    return PaddedLinearWave(LinearWave(mesh, p=p, dtype=BF16, device=device),
                            tile_x=tile_x, kernel=kernel)


def _several_tiles(pm, fields=1, extra=0):
    grid, *_ = tiling.tma_geometry(pm.layout, 2, tiling.H100_SMS, fields, extra)
    return min(grid[:2]) >= 2


@pytest.mark.parametrize("kernel", ["H", "I"])
@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_bf16_lf_kernels_match_plain_twins(cuda, kernel, p):
    """One bf16 call of kernel H (one leapfrog step) or I (two) from
    outputs and scratch full of NaN, on a grid of several y and z tiles,
    against the plain twin on the CPU: u and v within two ulps of max|ref|,
    the padding of the outputs and the scratch exactly 0; one model step
    launches the kernel's phases."""
    pm = _bf16_tiled_model(p, cuda, max(16, lf2step._off0(p)))
    pc = _bf16_tiled_model(p, "cpu", pm.layout.tile_x)
    assert pm.lf_unavailable is None and pm.lf2_unavailable is None
    assert _several_tiles(pm)
    u0, v0 = _bf16_state(pm.layout, 70 + p, cuda), _bf16_state(pm.layout, 71 + p, cuda, 1e3)
    dt, gs = 0.7e-9, (1.0e5, 0.6e5, 0.2e5)
    nan = [torch.full_like(u0, float("nan")) for _ in range(5)]
    face = (pm.stencil, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
    if kernel == "H":
        fn, n0 = lfstep.lf_step_cuda, lfstep.lf_step_cuda.launches
        got = fn(u0, v0, dt, *gs[:2], pm.layout, pm.base.c0, *face, out=tuple(nan[:2]),
                 scratch=nan[2])
        want = lfstep.lf_step_plain(u0.cpu(), v0.cpu(), dt, *gs[:2], pc.layout,
                                    pc.base.c0, pc.lf_tables)
        scratch, calls = nan[2:3], 2
    else:
        fn, n0 = lf2step.lf2_step_cuda, lf2step.lf2_step_cuda.launches
        got = fn(u0, v0, dt, *gs, pm.layout, pm.base.c0, *face, out=tuple(nan[:2]),
                 scratch=tuple(nan[2:]))
        want = lf2step.lf2_step_plain(u0.cpu(), v0.cpu(), dt, *gs, pc.layout,
                                      pc.base.c0, pc.lf2_tables)
        scratch, calls = nan[2:], 3
    torch.cuda.synchronize()
    assert fn.launches == n0 + calls
    for g, w in zip(got, want):
        assert g.dtype == BF16 and _bf16_rel(g, w) <= ONE_BF16
    assert all(_bf16_padding_zero(pm.layout, x) for x in (*got, *scratch))


@pytest.mark.parametrize("p", [1, 3, 4])
def test_bf16_rk42_kernel_matches_plain_twin(cuda, p):
    """One bf16 call of kernel J (two full-tableau RK4 steps, seven
    launches) and its step boundary alone, from outputs and scratch full
    of NaN on a grid of several y and z tiles, against the plain twins on
    the CPU: within two ulps of max|ref|, the padding exactly 0 (odd p
    included: C's stages take bf16 TMA windows)."""
    pm = _bf16_tiled_model(p, cuda, max(24, rk42step._off0(p)))
    pc = _bf16_tiled_model(p, "cpu", pm.layout.tile_x)
    assert pm.rk42_unavailable is None
    assert _several_tiles(pm, rk42step.BOUNDARY_FIELDS, rk42step.BOUNDARY_EXTRA)
    u0, v0 = _bf16_state(pm.layout, 80 + p, cuda), _bf16_state(pm.layout, 81 + p, cuda, 1e3)
    face = (pm.stencil, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
    cface = (pc.stencil, pc.face_w1, pc.face_w2, pc.src_x, pc.abc_x)
    nan = [torch.full_like(u0, float("nan")) for _ in range(8)]
    n0 = rk42step.rk42_step_cuda.launches
    got = rk42step.rk42_step_cuda(u0, v0, DT, RK42_GS, pm.layout, pm.base.c0, *face,
                                  out=tuple(nan[:2]), scratch=tuple(nan[2:]))
    want = rk42step.rk42_step_plain(u0.cpu(), v0.cpu(), DT, RK42_GS, pc.layout,
                                    pc.base.c0, *cface)
    torch.cuda.synchronize()
    assert rk42step.rk42_step_cuda.launches == n0 + rk42step.LAUNCHES_PER_CALL
    for g, w in zip(got, want):
        assert g.dtype == BF16 and _bf16_rel(g, w) <= ONE_BF16
    assert all(_bf16_padding_zero(pm.layout, x) for x in (*got, *nan[2:]))
    ins = [_bf16_state(pm.layout, 90 + p + j, cuda, sc)
           for j, sc in enumerate((1.0, 1e3, 1e9, 1e9, 1e9))]
    got = rk42step._rk42_boundary_cuda(
        *ins, DT, 0.5, pm.layout, pm.base.c0, *face,
        out=tuple(torch.full_like(ins[0], float("nan")) for _ in range(3)))
    want = rk42step.rk42_boundary_plain(*(x.cpu() for x in ins), DT, 0.5, pc.layout,
                                        pc.base.c0, *cface)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _bf16_rel(g, w) <= ONE_BF16 and _bf16_padding_zero(pm.layout, g)


@pytest.mark.parametrize("p,shape,kernel", [(9, (2, 2, 4), "flat"), (10, (2, 2, 4), "flat"),
                                            (4, (4, 3, 9), "3d")])
def test_bf16_slab_kernel_matches_plain_twin(cuda, p, shape, kernel):
    """One bf16 apply of kernel E (p > 8, or kernel='3d') from an output
    full of NaN on a grid of several y and z tiles, against the plain twin
    on the CPU: within two ulps of max|ref|, the padding exactly 0; a model
    step on f1 launches it four times."""
    pm = _bf16_tiled_model(p, cuda, 16, shape, kernel)
    pc = _bf16_tiled_model(p, "cpu", 16, shape, kernel)
    assert pm.kernel == "3d" and _several_tiles(pm)
    x = _bf16_state(pm.layout, 100 + p, cuda)
    y = wave.apply_slab_cuda(x, pm.layout, pm.slab_tables,
                             out=torch.full_like(x, float("nan")))
    want = wave.apply_slab_plain(x.cpu(), pc.layout, pc.slab_tables)
    torch.cuda.synchronize()
    assert y.dtype == BF16 and _bf16_rel(y, want) <= ONE_BF16
    assert _bf16_padding_zero(pm.layout, y)
    n0 = wave.apply_slab_cuda.launches
    u, v = pm.solve_n(0.0, DT, 1, x, 1e3 * x)
    torch.cuda.synchronize()
    assert wave.apply_slab_cuda.launches == n0 + 4 and u.dtype == BF16
    assert bool(torch.isfinite(v.float()).all())


# -- bf16 state: kernels G and K, and the sharded paths ----------------------------
@pytest.mark.parametrize("p,cells", [(1, (9, 40, 40)), (2, (5, 20, 20)), (4, (3, 9, 9)),
                                     (8, (2, 5, 5))])
def test_bf16_mass_kernel_matches_plain_twin(cuda, p, cells):
    """One bf16 apply of kernel G from an output full of NaN on a grid of
    several y and z tiles, against its plain twin (z, y, x, float32 sums,
    one rounding) on the CPU: within two ulps of max|ref|, the padding
    exactly 0; BP1 CG in bf16 launches it 1 + iters times."""
    mesh = box_mesh(cells, (1.0, 0.8, 1.2))
    lay, tabs, _ = mass.bp1_setup(mesh, p, BF16, cuda)
    layc, tabc, _ = mass.bp1_setup(mesh, p, BF16, "cpu")
    args = mass.mass_launch_args(_bf16_state(lay, 1, cuda), torch.empty(0), lay, tabs)
    assert args[-7] < lay.shape[1] or args[-6] < lay.shape[2]  # several tiles
    x = _bf16_state(lay, 200 + p, cuda)
    y = mass.mass_apply_cuda(x, lay, tabs, out=torch.full_like(x, float("nan")))
    want = mass.mass_apply_zyx_plain(x.cpu(), layc, tabc)
    torch.cuda.synchronize()
    assert y.dtype == BF16 and _bf16_rel(y, want) <= ONE_BF16
    assert _bf16_padding_zero(lay, y)
    n0 = mass.mass_apply_cuda.launches
    _, k, _ = cg(lambda v: mass.mass_apply(v, lay, tabs), x, kmax=5, rtol=1e-30)
    torch.cuda.synchronize()
    assert mass.mass_apply_cuda.launches == n0 + 1 + k


@pytest.mark.parametrize("kind", ["perturbed", "affine"])
@pytest.mark.parametrize("rule,p", [("gll", 2), ("gll", 4), ("gll", 6), ("gauss", 2),
                                    ("gauss", 4)])
def test_bf16_general_kernel_matches_plain_twin(cuda, rule, p, kind):
    """Kernel K in bf16 in every mode (collocated: mass, stiffness; Gauss:
    mass_gauss, stiffness_gauss; affine cells on a box) on a mesh of
    several colours, from an output full of NaN, against its plain twin on
    the CPU (float32 colours, one rounding): within two ulps of max|ref|;
    two applies bitwise equal."""
    if kind == "affine":
        if rule == "gauss":
            pytest.skip("affine geometry serves the collocated modes only")
        mesh = box_mesh((5, 4, 3), (1.0, 0.8, 0.9)).to_hex_mesh()
    else:
        mesh, _ = perturbed_box((5, 4, 3) if p < 6 else (3, 2, 2), h=0.25)
    ops = GeneralOperators(mesh, build_dofmap(mesh, p), dtype=BF16, rule=rule)
    assert ops.affine == (kind == "affine")
    x = torch.as_tensor(np.random.default_rng(300 + p).standard_normal(ops.ndofs),
                        device=cuda).to(BF16)
    for op, coeff in (("mass", 1.0), ("stiffness", -1500.0**2)):
        t = ops.tables(ops.mode(op), cuda)
        tc = ops.tables(ops.mode(op), "cpu")
        assert t.ncolours >= 2 and t.geo.dtype == BF16
        y = general.general_apply_cuda(x, t, coeff, out=torch.full_like(x, float("nan")))
        y2 = general.general_apply_cuda(x, t, coeff)
        want = general.general_apply_plain(x.cpu(), tc, coeff)
        torch.cuda.synchronize()
        assert y.dtype == BF16 and torch.equal(y, y2)
        assert _bf16_rel(y, want) <= ONE_BF16


def test_bf16_general_model_and_cg_on_kernel_k(cuda):
    """The imported-mesh model in bf16 on the card (kernel K, set-up on the
    card) against the same model on the CPU (the plain twin) over 10 RK4
    steps within 1e-2 (relative L2); CG on K's mass_gauss in bf16 runs to
    kmax with float32 dots."""
    mesh, tags = perturbed_box((4, 3, 2), h=0.002)
    mk = GeneralLinearWave(mesh, 2, tags, dtype=BF16, device=cuda)
    mc = GeneralLinearWave(mesh, 2, tags, dtype=BF16, device="cpu")
    for name in ("m", "inv_m", "W1", "W2"):
        assert torch.equal(getattr(mk, name).cpu(), getattr(mc, name))
    dt = 0.5 * min_edge(mesh) / (1500.0 * 4)
    uk, vk = mk.solve_n(0.0, dt, 10)
    uc, vc = mc.solve_n(0.0, dt, 10)
    torch.cuda.synchronize()
    for a, b in ((uk, uc), (vk, vc)):
        assert float((a.cpu().float() - b.float()).norm() / b.float().norm()) <= 1e-2
    ops = GeneralOperators(mesh, build_dofmap(mesh, 2, device=cuda), dtype=BF16,
                           rule="gauss", device=cuda)
    b = torch.ones(ops.ndofs, dtype=BF16, device=cuda)
    n0 = general.general_apply_cuda.launches
    x, k, rnorm = cg(ops.mass, b, kmax=8, rtol=1e-30)
    torch.cuda.synchronize()
    assert x.dtype == BF16 and rnorm.dtype == torch.float32
    assert general.general_apply_cuda.launches == n0 + 1 + k


@pytest.mark.parametrize("path", ["step", "lf2", "n"])
def test_bf16_sharded_solve_matches_single_device(cuda, path):
    """One sharded bf16 solve on (2,2,1) blocks on the card (A, I, or B per
    block), 40 steps at the app's dt, against one device's bf16 solve on
    the card: the value-halo paths (A, I) bit for bit; the per-stage
    halo-add (B) within 1.5x one device's bf16 error against its float64
    solve (tests/test_torch_bf16_sharded.py says why)."""
    from wave_fenics_tpu_torch.models.planar3d import planar3d_case
    from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave

    cases = [planar3d_case((4, 2, 2), domain_length=0.01, degree=4, dtype=d, device=cuda)
             for d in (BF16, torch.float64)]
    dt, nsteps = cases[0].dt, 40
    sw = ShardedPaddedWave(cases[0].model, (2, 2, 1), tile_x=16)
    pm, p64 = (PaddedLinearWave(c.model, tile_x=16) for c in cases)
    solver, to_global = {"step": ("solve_step_n", "to_global_step"),
                         "lf2": ("solve_lf2_n", "to_global_lf2"),
                         "n": ("solve_n", "to_global")}[path]
    u, v, _ = getattr(sw, solver)(0.0, dt, nsteps)
    ur, vr = getattr(pm, solver)(0.0, dt, nsteps)[:2]
    r64 = getattr(p64, solver)(0.0, dt, nsteps)[:2]
    torch.cuda.synchronize()
    for g, r, ref in zip((getattr(sw, to_global)(u), getattr(sw, to_global)(v)), (ur, vr), r64):
        r = pm.to_grid(r).float().cpu().numpy()
        assert np.abs(r).max() > 0
        if path == "n":
            ref = p64.to_grid(ref).cpu().numpy()
            assert np.linalg.norm(g - ref) <= 1.5 * np.linalg.norm(r - ref)
        else:
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("path,p,rings", HALO_CASES)
@pytest.mark.parametrize("shape", [(4, 2, 2), (16, 16, 16)])
def test_bf16_halo_layout_kernels_match_plain_over_nan(cuda, path, p, rings, shape):
    """Kernels A, H and I in bf16 on the value-halo layouts, one call on
    each block of a (2,2,1) split (at (16,16,16) cells, several y and z
    tiles a block) from output and scratch buffers full of NaN: the
    interior against the plain bf16 twin within two ulps of max|ref|, the
    outputs exactly 0 outside their ring, nothing left NaN."""
    sw = _sharded(p, cuda, (2, 2, 1), shape=shape, dtype=BF16)
    lay = sw.halo_layout(path)
    u0, v0 = _halo_state(sw, lay, 51, scale=1e3)
    inter = lay.interior
    for b, (tables, st, src_x, abc_x) in enumerate(sw._halo_tables(path)):
        nan = [torch.full_like(u0[b], float("nan")) for _ in range(5)]
        c0 = sw.model.c0
        if path == "step":
            uk, vk = rk4step.rk4_step_lean(u0[b], v0[b], DT, GS, lay, c0, tables, st, src_x,
                                           abc_x, out=tuple(nan[:2]), scratch=tuple(nan[2:]))
            up, vp = rk4step.rk4_step_lean_plain(u0[b], v0[b], DT, GS, lay, c0, tables)
        elif path == "lf":
            uk, vk = lfstep.lf_step(u0[b], v0[b], DT, 1.0, 0.6, lay, c0, tables, st, src_x,
                                    abc_x, out=tuple(nan[:2]), scratch=nan[2])
            up, vp = lfstep.lf_step_plain(u0[b], v0[b], DT, 1.0, 0.6, lay, c0, tables)
            nan = nan[:3]
        else:
            uk, vk = lf2step.lf2_step(u0[b], v0[b], DT, 1.0, 0.6, 0.2, lay, c0, tables, st,
                                      src_x, abc_x, out=tuple(nan[:2]),
                                      scratch=tuple(nan[2:]))
            up, vp = lf2step.lf2_step_plain(u0[b], v0[b], DT, 1.0, 0.6, 0.2, lay, c0,
                                            tables)
        torch.cuda.synchronize()
        assert not any(bool(torch.isnan(x).any()) for x in nan)
        assert _bf16_rel(uk[inter], up[inter]) <= ONE_BF16
        assert _bf16_rel(vk[inter], vp[inter]) <= ONE_BF16
        _outside_box_zero(lay, rings[0], uk)
        _outside_box_zero(lay, rings[1], vk)


# -- the benchmark suite (benchmarks/suite.py, benchmarks/common.py) ----------
def test_stream_ceiling_on_the_card(cuda):
    """The measured streaming ceiling (a copy four times the L2 or more,
    two-point) lies within 1,500-3,350 GB/s (above the H100's 3.35 TB/s the
    timing or the byte count is wrong), cached per card; a record's
    percentage of it follows the JAX formula."""
    from wave_fenics_tpu_torch.benchmarks import common

    c = common.stream_ceiling_gbps(cuda)
    assert 1500.0 <= c <= 3350.0
    assert common.stream_ceiling_gbps("cuda") == c
    f = common.streaming_fields(1e9, 1e-3, cuda)
    assert f["pct_of_measured_ceiling"] == round(100.0 * 1000.0 / c, 1)


@pytest.mark.parametrize("solver,kernel", [("padded", "B"), ("fused", "D"), ("step", "A")])
def test_suite_headline_on_the_card(cuda, solver, kernel):
    """Each headline record at the quick suite's 32x16x16 cells, p=4, 50
    steps: a two-point rate, its kernel launched 4 times a step over the
    warm-up call and the six windows and no other kernel, and the step
    record's percentage of the ceiling within (0, 100]."""
    from wave_fenics_tpu_torch.benchmarks import suite

    counters = {"A": rk4step.rk4_step_lean_cuda, "B": wave.apply_flat_cuda,
                "D": wave.rk_stage_cuda, "C": rk4step.rk4_step_full_cuda,
                "E": wave.apply_slab_cuda, "F": stiffness.stiffness_grid_cuda}
    for fn in counters.values():
        fn.launches = 0
    r = suite.headline(cells=(32, 16, 16), degree=4, steps=50, solver=solver)
    launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
    assert launched == {kernel: 4 * (50 + 3 * 50 + 3 * 12)}
    assert r["timing"] == "two-point (50-12 steps)"
    assert r["device"] == torch.cuda.get_device_name(cuda)
    assert r["value"] > 0 and r["ms_per_step"] > 0 and "vs_baseline" not in r
    if solver == "step":
        assert 0 < r["pct_of_measured_ceiling"] <= 100
    else:
        assert "pct_of_measured_ceiling" not in r
    _, _, solve = suite.headline_solver((32, 16, 16), 4, solver, "cuda")
    u, v = solve(50)
    assert torch.isfinite(u).all() and torch.isfinite(v).all() and v.abs().max() > 0
