"""One classic RK4 step of the padded wave system (kernel A).

Port of ``wave_fenics_tpu.ops.pallas_rk4step``. For the linear system
u' = v, v' = A u + g(t) S + D v (A = -c0^2 K/m, S the source plane, D the
absorbing plane) the classic RK4 tableau (LinearGLL.hpp:233-287) collapses
exactly to the lean form of ``_kernel_rk4_step_lean``:

    un1 = u0 + dt/2 v0          un2 = un1 + dt^2/4 kv0
    un3 = (u0 + dt v0) + dt^2/2 kv1
    u1  = (u0 + dt v0) + dt^2/6 (kv0 + kv1 + kv2)
    v1  = v0 + dt/6 (kv0 + 2 kv1 + 2 kv2 + kv3)

with kv_j = A un_j + c0^2 g_j W1 - c0 W2 vn_j on the x-face rows.

Implementations:

- :func:`rk4_step_lean_plain`: plain torch, mirroring the TPU kernel tile
  by tile (3p-deep slab windows shrinking by p per stage, band-matrix x
  term, rolled y/z taps with the merged shift-0 tap, the same tables);
- :func:`rk4_step_full_plain`: the full-tableau step of the TPU kernel
  ``_kernel_rk4_step`` (kernel C), kept as a test oracle of the lean
  algebra;
- :func:`rk4_step_lean_cuda`: the hand-written CUDA kernel
  (``csrc/wave_kernels.cu::rk4_stage_kernel``), four launches per step,
  one per stage.

:func:`rk4_step_lean` dispatches on the tensor's device: CPU -> plain,
CUDA -> kernel (or raise).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..convert import numpy_dtype
from . import _cuda
from .wave import (
    PaddedLayout,
    StencilTables,
    _check_no_tf32,
    axis_cv_tables,
    check_stencil,
    stencil_args,
)

__all__ = [
    "StepTables",
    "build_step_tables",
    "build_step_tables_from_cv",
    "rk4_step_lean",
    "rk4_step_lean_plain",
    "rk4_step_full_plain",
    "rk4_step_lean_cuda",
]

_RK_A = (0.0, 0.5, 0.5, 1.0)
_RK_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def _off0(p: int) -> int:
    """Slab x-halo depth: >= 3p, 8-aligned (the TPU's 2D DMA sublane rule)."""
    return -(-3 * p // 8) * 8


def build_step_tables(
    layout: PaddedLayout,
    A: list[np.ndarray],
    lines: list[np.ndarray],
    coeff: float,
    inv_m_lines: list[np.ndarray],
    w1_flat: np.ndarray,
    w2_flat: np.ndarray,
    src_x: int,
    abc_x: int,
    dtype=np.float32,
) -> tuple[np.ndarray, ...]:
    """Static tables of the step: (WXA, WXB, WXC, CVY, CVZ, FX, SXS, SRC,
    ABC, W1, W2) — per-tile band matrices for the three window shapes, the
    flattened-plane stencil tables with the line factors folded in,
    slab-aligned SX / source / ABC row masks, and the 1/m-premultiplied
    facet-weight planes."""
    cvx, cvy, cvz, pLx, pLy, pLz = axis_cv_tables(
        layout, A, lines, coeff, inv_m_lines
    )
    return build_step_tables_from_cv(
        layout, cvx, cvy, cvz, pLx, pLy, pLz,
        w1_flat, w2_flat, src_x, abc_x, dtype,
    )


def build_step_tables_from_cv(
    layout: PaddedLayout,
    cvx: np.ndarray, cvy: np.ndarray, cvz: np.ndarray,
    pLx: np.ndarray, pLy: np.ndarray, pLz: np.ndarray,
    w1_flat: np.ndarray,
    w2_flat: np.ndarray,
    src_x: int,
    abc_x: int,
    dtype=np.float32,
) -> tuple[np.ndarray, ...]:
    """Step tables from pre-built padded coefficient/line vectors.
    ``src_x`` / ``abc_x`` are padded x-rows, or -1 when the face is absent.

    The flattened-plane line factors (gz = tile(pLz), gy = repeat(pLy))
    are folded into the CVY/CVZ stencil tables."""
    p = layout.p
    Tx = layout.tile_x
    Lx, Ly, Lz = layout.padded_shape
    K = 2 * p + 1
    off0 = _off0(p)
    S0 = Tx + 2 * off0
    F = Ly * Lz
    npdt = numpy_dtype(dtype)

    ntiles = Lx // Tx
    o2, o1, o0 = off0 - 2 * p, off0 - p, off0
    shapes = [(o2, Tx + 4 * p), (o1, Tx + 2 * p), (o0, Tx)]
    bands = []
    for o_w, nrows in shapes:
        W = np.zeros((ntiles, nrows, nrows + 2 * p))
        for t in range(1, ntiles - 1):
            base = t * Tx - off0
            for r in range(nrows):
                g = base + o_w + r
                if 0 <= g < Lx:
                    for k in range(K):
                        W[t, r, r + k] = cvx[k, g]
        bands.append(W.astype(npdt))
    WXA, WXB, WXC = bands

    gz = np.tile(pLz, Ly).reshape(1, F)
    gy = np.repeat(pLy, Lz).reshape(1, F)
    CVY = (np.repeat(cvy, Lz, axis=1) * gz).astype(npdt)  # [K, F], gz folded
    CVZ = (np.tile(cvz, (1, Ly)) * gy).astype(npdt)       # [K, F], gy folded
    FX = np.outer(pLy, pLz).reshape(1, F).astype(npdt)

    # slab-aligned row tables: SXS[t, r] = SX[t*Tx - off0 + r]
    SXS = np.zeros((ntiles, S0, 1))
    SRC = np.zeros((ntiles, S0, 1))
    ABC = np.zeros((ntiles, S0, 1))
    for t in range(ntiles):
        base = t * Tx - off0
        for r in range(S0):
            g = base + r
            if 0 <= g < Lx:
                SXS[t, r, 0] = pLx[g]
                SRC[t, r, 0] = 1.0 if g == src_x else 0.0
                ABC[t, r, 0] = 1.0 if g == abc_x else 0.0

    W1 = np.asarray(w1_flat).reshape(1, F).astype(npdt)
    W2 = np.asarray(w2_flat).reshape(1, F).astype(npdt)
    return (WXA, WXB, WXC, CVY, CVZ, FX,
            SXS.astype(npdt), SRC.astype(npdt), ABC.astype(npdt), W1, W2)


class StepTables(NamedTuple):
    """Tensors of :func:`build_step_tables`."""

    WXA: torch.Tensor
    WXB: torch.Tensor
    WXC: torch.Tensor
    CVY: torch.Tensor
    CVZ: torch.Tensor
    FX: torch.Tensor
    SXS: torch.Tensor
    SRC: torch.Tensor
    ABC: torch.Tensor
    W1: torch.Tensor
    W2: torch.Tensor


def _check_step_layout(layout: PaddedLayout) -> None:
    layout.check_flat()
    if layout.tile_x < _off0(layout.p):
        raise ValueError(
            f"tile_x = {layout.tile_x} must be >= {_off0(layout.p)} (the "
            "3p-deep slab halo must stay inside the all-pad x tiles)"
        )


class _TileStep:
    """Shared per-tile machinery of the two plain step versions."""

    def __init__(self, u0, v0, dt, gs, layout, c0, tables):
        _check_no_tf32(u0)
        _check_step_layout(layout)
        self.tb = StepTables(*tables)
        self.layout = layout
        self.p = layout.p
        Lx, Ly, Lz = layout.padded_shape
        self.Lz, self.F = Lz, Ly * Lz
        dev, dtype = u0.device, u0.dtype
        sc = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
        # scalars in the state dtype, formed as the TPU kernel forms them
        self.dt = sc(dt)
        self.g = [sc(g) for g in gs]
        self.c0sq = sc(c0 * c0)
        self.mc0 = sc(-c0)
        self.half = sc(0.5)
        self.dt2 = self.dt * self.dt
        self.u = u0.reshape(Lx, self.F)
        self.v = v0.reshape(Lx, self.F)

    def tiles(self):
        Tx, off0 = self.layout.tile_x, _off0(self.p)
        S0 = Tx + 2 * off0
        for t in range(1, self.layout.padded_shape[0] // Tx - 1):
            s = t * Tx - off0
            yield t, self.u[s : s + S0], self.v[s : s + S0]

    def apply_A(self, t, xin, wx, o, nrows, lean):
        """A x on slab rows [o, o+nrows); xin = x on [o-p, o+nrows+p)."""
        p, tb, F, Lz = self.p, self.tb, self.F, self.Lz
        K = 2 * p + 1
        xc = xin[p : p + nrows]
        sx = tb.SXS[t, o : o + nrows]
        out = (wx[t] @ xin) * tb.FX
        if lean:
            # the two shift-0 taps merged; terms summed in chunks of 9
            terms = [(tb.CVY, k, ((p - k) * Lz) % F) for k in range(K) if k != p]
            terms += [(tb.CVZ, k, (p - k) % F) for k in range(K) if k != p]
            e0 = (tb.CVY[p] + tb.CVZ[p])[None, :] * xc
            acc = None
            for i in range(0, len(terms), 9):
                e = e0 if i == 0 else None
                for ref, k, sh in terms[i : i + 9]:
                    tk = ref[k][None, :] * torch.roll(xc, sh, 1)
                    e = tk if e is None else e + tk
                acc = e if acc is None else acc + e
        else:
            terms = [(tb.CVY, k, ((p - k) * Lz) % F) for k in range(K)]
            terms += [(tb.CVZ, k, (p - k) % F) for k in range(K)]
            acc = None
            for ref, k, sh in terms:
                xs = xc if sh == 0 else torch.roll(xc, sh, 1)
                tk = ref[k][None, :] * xs
                acc = tk if acc is None else acc + tk
        return out + acc * sx

    def new_state(self):
        return torch.zeros_like(self.u), torch.zeros_like(self.v)

    def out_rows(self, t):
        Tx = self.layout.tile_x
        return slice(t * Tx, (t + 1) * Tx)

    def finish(self, u1, v1):
        shape = self.layout.padded_shape
        return u1.reshape(shape), v1.reshape(shape)


def rk4_step_lean_plain(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    gs: tuple[float, float, float, float],
    layout: PaddedLayout,
    c0: float,
    tables: StepTables,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One lean RK4 step on padded [Lx, Ly, Lz] states, mirroring
    ``_kernel_rk4_step_lean`` tile by tile; the all-pad tiles are zeros."""
    ts = _TileStep(u0, v0, dt, gs, layout, c0, tables)
    tb, p, Tx = ts.tb, ts.p, layout.tile_x
    off0 = _off0(p)
    o3, o2, o1, o0 = off0 - 3 * p, off0 - 2 * p, off0 - p, off0
    n2, n1, n0 = Tx + 4 * p, Tx + 2 * p, Tx
    dt_, half, dt2 = ts.dt, ts.half, ts.dt2
    u1, v1 = ts.new_state()
    for t, U0, V0 in ts.tiles():
        has_src = bool(tb.SRC[t].abs().max() > 0)
        has_abc = bool(tb.ABC[t].abs().max() > 0)

        def face_terms(kv, gj, vn_fn, o, nrows):
            # source + ABC rank-1 face updates, only on tiles whose slab
            # window holds a face row; vn is formed only there
            if has_src:
                kv = kv + (ts.c0sq * gj) * (tb.SRC[t, o : o + nrows] * tb.W1)
            if has_abc:
                kv = kv + ts.mc0 * (tb.ABC[t, o : o + nrows] * tb.W2) * vn_fn()
            return kv

        kv0 = ts.apply_A(t, U0[o3 : o3 + n2 + 2 * p], tb.WXA, o2, n2, True)
        kv0 = face_terms(kv0, ts.g[0], lambda: V0[o2 : o2 + n2], o2, n2)

        un1 = U0[o2 : o2 + n2] + (half * dt_) * V0[o2 : o2 + n2]
        kv1 = ts.apply_A(t, un1, tb.WXB, o1, n1, True)
        kv1 = face_terms(
            kv1, ts.g[1],
            lambda: V0[o1 : o1 + n1] + (half * dt_) * kv0[o1 - o2 : o1 - o2 + n1],
            o1, n1,
        )

        un2 = un1 + (0.25 * dt2) * kv0
        kv2 = ts.apply_A(t, un2, tb.WXB, o1, n1, True)
        kv2 = face_terms(
            kv2, ts.g[2], lambda: V0[o1 : o1 + n1] + (half * dt_) * kv1, o1, n1
        )

        w = U0[o1 : o1 + n1] + dt_ * V0[o1 : o1 + n1]
        un3 = w + (half * dt2) * kv1
        kv3 = ts.apply_A(t, un3, tb.WXC, o0, n0, True)
        kv3 = face_terms(
            kv3, ts.g[3],
            lambda: V0[o0 : o0 + n0] + dt_ * kv2[o0 - o1 : o0 - o1 + n0],
            o0, n0,
        )

        c2, c1 = o0 - o2, o0 - o1
        s2 = kv0[c2 : c2 + n0] + kv1[c1 : c1 + n0] + kv2[c1 : c1 + n0]
        rows = ts.out_rows(t)
        u1[rows] = w[c1 : c1 + n0] + (dt2 / 6.0) * s2
        v1[rows] = V0[o0 : o0 + n0] + (dt_ / 6.0) * (
            s2 + kv1[c1 : c1 + n0] + kv2[c1 : c1 + n0] + kv3
        )
    return ts.finish(u1, v1)


def rk4_step_full_plain(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    gs: tuple[float, float, float, float],
    layout: PaddedLayout,
    c0: float,
    tables: StepTables,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One RK4 step with the full Butcher tableau and running b_j-weighted
    accumulators, mirroring ``_kernel_rk4_step`` (kernel C): the oracle the
    lean algebra is tested against."""
    ts = _TileStep(u0, v0, dt, gs, layout, c0, tables)
    tb, p, Tx = ts.tb, ts.p, layout.tile_x
    off0 = _off0(p)
    o3, o2, o1, o0 = off0 - 3 * p, off0 - 2 * p, off0 - p, off0
    n2, n1, n0 = Tx + 4 * p, Tx + 2 * p, Tx
    dt_ = ts.dt
    u1, v1 = ts.new_state()
    for t, U0, V0 in ts.tiles():

        def bc(kv, vn, gj, o, nrows):
            src = tb.SRC[t, o : o + nrows]
            abc = tb.ABC[t, o : o + nrows]
            return kv + (ts.c0sq * gj) * (src * tb.W1) + ts.mc0 * (abc * tb.W2) * vn

        kv0 = bc(ts.apply_A(t, U0[o3 : o3 + n2 + 2 * p], tb.WXA, o2, n2, False),
                 V0[o2 : o2 + n2], ts.g[0], o2, n2)
        accu = _RK_B[0] * V0[o0 : o0 + n0]
        accv = _RK_B[0] * kv0[o0 - o2 : o0 - o2 + n0]

        ca = _RK_A[1] * dt_
        un1 = U0[o2 : o2 + n2] + ca * V0[o2 : o2 + n2]
        vn1 = V0[o2 : o2 + n2] + ca * kv0
        kv1 = bc(ts.apply_A(t, un1, tb.WXB, o1, n1, False),
                 vn1[o1 - o2 : o1 - o2 + n1], ts.g[1], o1, n1)
        accu = accu + _RK_B[1] * vn1[o0 - o2 : o0 - o2 + n0]
        accv = accv + _RK_B[1] * kv1[o0 - o1 : o0 - o1 + n0]

        ca = _RK_A[2] * dt_
        un2 = U0[o2 : o2 + n2] + ca * vn1
        vn2 = V0[o1 : o1 + n1] + ca * kv1
        kv2 = bc(ts.apply_A(t, un2, tb.WXB, o1, n1, False), vn2, ts.g[2], o1, n1)
        accu = accu + _RK_B[2] * vn2[o0 - o1 : o0 - o1 + n0]
        accv = accv + _RK_B[2] * kv2[o0 - o1 : o0 - o1 + n0]

        ca = _RK_A[3] * dt_
        un3 = U0[o1 : o1 + n1] + ca * vn2
        vn3 = V0[o1 : o1 + n1] + ca * kv2
        kv3 = bc(ts.apply_A(t, un3, tb.WXC, o0, n0, False),
                 vn3[o0 - o1 : o0 - o1 + n0], ts.g[3], o0, n0)
        accu = accu + _RK_B[3] * vn3[o0 - o1 : o0 - o1 + n0]
        accv = accv + _RK_B[3] * kv3

        rows = ts.out_rows(t)
        u1[rows] = U0[o0 : o0 + n0] + dt_ * accu
        v1[rows] = V0[o0 : o0 + n0] + dt_ * accv
    return ts.finish(u1, v1)


def rk4_step_lean_cuda(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    gs: tuple[float, float, float, float],
    layout: PaddedLayout,
    c0: float,
    st: StencilTables,
    w1: torch.Tensor,
    w2: torch.Tensor,
    src_x: int,
    abc_x: int,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
    scratch: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One lean RK4 step with the CUDA kernel A: four launches, one per
    stage. ``w1``/``w2`` are the [1, F] facet planes (StepTables.W1/W2),
    ``src_x``/``abc_x`` their padded x rows. ``out`` = (u1, v1) and
    ``scratch`` = (kv0, kv1, kv2) are reused when given (the caller
    allocates them once); ``out`` must not alias (u0, v0), because stage 3
    reads the neighbours of u0 while it writes u1."""
    _check_step_layout(layout)
    shape = layout.padded_shape
    F = shape[1] * shape[2]
    dev, dtype = u0.device, u0.dtype
    if out is None:
        out = (torch.empty_like(u0), torch.empty_like(v0))
    if scratch is None:
        scratch = tuple(torch.empty_like(u0) for _ in range(3))
    u1, v1 = out
    kv0, kv1, kv2 = scratch
    _cuda.check_operands(
        dev, dtype,
        u0=(u0, shape), v0=(v0, shape), u1=(u1, shape), v1=(v1, shape),
        kv0=(kv0, shape), kv1=(kv1, shape), kv2=(kv2, shape),
        w1=(w1, (1, F)), w2=(w2, (1, F)),
    )
    check_stencil(layout, st, dev, dtype)
    written = [t.data_ptr() for t in (u1, v1, kv0, kv1, kv2)]
    if len(set(written)) != 5 or {u0.data_ptr(), v0.data_ptr()} & set(written):
        raise ValueError("the outputs and the scratch must not alias each "
                         "other or the inputs")
    for j in range(4):
        kv_out = scratch[j] if j < 3 else kv2  # stage 3 writes u1, v1
        _cuda.launch(
            "wave_rk4_stage", dtype, dev, j, u0, v0, kv0, kv1, kv2, kv_out,
            u1, v1, w1, w2, int(src_x), int(abc_x), float(dt), float(gs[j]),
            float(c0), *stencil_args(layout, st),
        )
        rk4_step_lean_cuda.launches += 1
    return u1, v1


#: process-wide count of kernel A launches (four per step; diagnostics:
#: shows that a run went through the kernel)
rk4_step_lean_cuda.launches = 0
LAUNCHES_PER_STEP = 4


def rk4_step_lean(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    gs: tuple[float, float, float, float],
    layout: PaddedLayout,
    c0: float,
    tables: StepTables,
    st: StencilTables,
    src_x: int,
    abc_x: int,
    out=None,
    scratch=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One lean RK4 step: plain version for CPU tensors, kernel A for CUDA
    ones (``out``/``scratch`` are the kernel's reusable buffers)."""
    if u0.device.type == "cpu":
        return rk4_step_lean_plain(u0, v0, dt, gs, layout, c0, tables)
    if u0.device.type == "cuda":
        return rk4_step_lean_cuda(u0, v0, dt, gs, layout, c0, st,
                                  tables.W1, tables.W2, src_x, abc_x,
                                  out=out, scratch=scratch)
    raise ValueError(f"no implementation of rk4_step_lean for device {u0.device}")
