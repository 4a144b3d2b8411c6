"""Two leapfrog steps per call of the padded wave system (kernel I).

Port of ``wave_fenics_tpu.ops.pallas_lf2step``. Two kick-drift-kick steps
(``ops/lfstep.py``) share their step-boundary force: F(t + dt, u1) closes
step 1 and opens step 2, so two steps cost three stencil applies:

    v+1 = (v0 + dt/2 F(t, u0)) / (1 + dt/2 D),        u1 = u0 + dt v+1
    v1  = (1 - dt/2 D) v+1 + dt/2 F(t + dt, u1)
    v+2 = (v1 + dt/2 F(t + dt, u1)) / (1 + dt/2 D),   u2 = u1 + dt v+2
    v2  = (1 - dt/2 D) v+2 + dt/2 F(t + 2 dt, u2)

Implementations:

- :func:`lf2_step_plain`: plain torch, mirroring ``_kernel_lf2_step`` tile
  by tile (3p-deep slab windows, three nested stencil windows, the same
  tables);
- :func:`lf2_step_cuda`: the hand-written CUDA kernel
  (``csrc/lf_tiled.cu::lf_phase_tiled_kernel``, kernel H's), three launches
  per call (OPEN, MID, CLOSE).

On a value-halo layout (halo = 3p of neighbour values) the phases write the
interior grown by ``lfstep.phase_rings`` (2p, p, 0) and zeros beyond; the
plain version computes what the TPU kernel computes over the whole plane.
Both agree on the interior.

:func:`lf2_step` dispatches on the tensor's device: CPU -> plain, CUDA ->
kernel (or raise).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..convert import as_table
from . import _cuda
from .lfstep import (
    LF_CLOSE,
    LF_MID,
    LF_OPEN,
    LeapfrogTerms,
    check_lf_layout,
    check_lf_operands,
    launch_lf_phase,
    phase_rings,
)
from .rk4step import _TileStep
from .wave import PaddedLayout, StencilTables, axis_cv_tables

__all__ = [
    "LF2Tables",
    "build_lf2_tables",
    "build_lf2_tables_from_cv",
    "lf2_step",
    "lf2_step_plain",
    "lf2_step_cuda",
]


def _off0(p: int) -> int:
    """Slab x-halo depth: >= 3p (two nested stencil windows + the A-window's
    own apply halo), 8-aligned (the TPU's 2D DMA sublane rule)."""
    return -(-3 * p // 8) * 8


def build_lf2_tables(
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
    """Static tables of the 2-step leapfrog: (WXA, WXB, WXC, CVY, CVZ, FX,
    SXS, SRC, ABC, W1, W2)."""
    cvx, cvy, cvz, pLx, pLy, pLz = axis_cv_tables(
        layout, A, lines, coeff, inv_m_lines
    )
    return build_lf2_tables_from_cv(
        layout, cvx, cvy, cvz, pLx, pLy, pLz,
        w1_flat, w2_flat, src_x, abc_x, dtype,
    )


def build_lf2_tables_from_cv(
    layout: PaddedLayout,
    cvx: np.ndarray, cvy: np.ndarray, cvz: np.ndarray,
    pLx: np.ndarray, pLy: np.ndarray, pLz: np.ndarray,
    w1_flat: np.ndarray,
    w2_flat: np.ndarray,
    src_x: int,
    abc_x: int,
    dtype=np.float32,
) -> tuple[np.ndarray, ...]:
    """2-step leapfrog tables from pre-built padded coefficient/line vectors
    (the leapfrog step's tables with three window shapes and the 3p halo)."""
    p = layout.p
    Tx = layout.tile_x
    Lx, Ly, Lz = layout.padded_shape
    K = 2 * p + 1
    off0 = _off0(p)
    S0 = Tx + 2 * off0
    F = Ly * Lz

    ntiles = Lx // Tx
    oA, oB, oC = off0 - 2 * p, off0 - p, off0
    shapes = [(oA, Tx + 4 * p), (oB, Tx + 2 * p), (oC, Tx)]
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
        bands.append(as_table(W, dtype))
    WXA, WXB, WXC = bands

    gz = np.tile(pLz, Ly).reshape(1, F)
    gy = np.repeat(pLy, Lz).reshape(1, F)
    CVY = as_table(np.repeat(cvy, Lz, axis=1) * gz, dtype)
    CVZ = as_table(np.tile(cvz, (1, Ly)) * gy, dtype)
    FX = as_table(np.outer(pLy, pLz).reshape(1, F), dtype)

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

    W1 = as_table(np.asarray(w1_flat).reshape(1, F), dtype)
    W2 = as_table(np.asarray(w2_flat).reshape(1, F), dtype)
    return (WXA, WXB, WXC, CVY, CVZ, FX,
            *(as_table(t, dtype) for t in (SXS, SRC, ABC)), W1, W2)


class LF2Tables(NamedTuple):
    """Tensors of :func:`build_lf2_tables`."""

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


def lf2_step_plain(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    g0: float,
    g1: float,
    g2: float,
    layout: PaddedLayout,
    c0: float,
    tables: LF2Tables,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two leapfrog steps on padded [Lx, Ly, Lz] states, mirroring
    ``_kernel_lf2_step`` tile by tile (gj = g(t + j dt)); the all-pad tiles
    are zeros. A bf16 call runs in float32 and rounds where kernel I's
    phases store: v+1 and u1 in OPEN, v+2 and u2 in MID (each u from its v+
    as stored; MID's v1 is never stored), v2 at the end."""
    p = layout.p
    check_lf_layout(layout, _off0(p), "3p")
    ts = _TileStep(u0, v0, dt, (g0, g1, g2), layout, c0, LF2Tables(*tables),
                   _off0(p))
    lt = LeapfrogTerms(ts, c0)
    tb, Tx = ts.tb, layout.tile_x
    off0 = _off0(p)
    oA, oB, oC = off0 - 2 * p, off0 - p, off0
    nA, nB, nC = Tx + 4 * p, Tx + 2 * p, Tx
    dt_, dt2, one = ts.dt, lt.dt2, lt.one
    u2, v2 = ts.new_state()
    for t, U0, V0 in ts.tiles():
        # step 1 on the A-window
        F0 = lt.force(t, lt.apply_A(t, U0[oA - p : oA - p + nA + 2 * p], tb.WXA,
                                    oA, nA), ts.g[0], oA, nA)
        vplus1 = ts.stored((V0[oA : oA + nA] + dt2 * F0)
                           / (one + dt2 * lt.damp(t, oA, nA)))
        u1 = ts.stored(U0[oA : oA + nA] + dt_ * vplus1)

        # step boundary: F1 once on the B-window
        sAB = oB - oA
        F1 = lt.force(t, lt.apply_A(t, u1, tb.WXB, oB, nB), ts.g[1], oB, nB)
        DB = lt.damp(t, oB, nB)
        v1 = (one - dt2 * DB) * vplus1[sAB : sAB + nB] + dt2 * F1

        # step 2 on the B-window
        vplus2 = ts.stored((v1 + dt2 * F1) / (one + dt2 * DB))
        u2w = ts.stored(u1[sAB : sAB + nB] + dt_ * vplus2)

        # close step 2 on the output rows
        sBC = oC - oB
        F2 = lt.force(t, lt.apply_A(t, u2w, tb.WXC, oC, nC), ts.g[2], oC, nC)
        rows = ts.out_rows(t)
        v2[rows] = (one - dt2 * lt.damp(t, oC, nC)) * vplus2[sBC : sBC + nC] + dt2 * F2
        u2[rows] = u2w[sBC : sBC + nC]
    return ts.finish(u2, v2)


def lf2_step_cuda(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    g0: float,
    g1: float,
    g2: float,
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
    """Two leapfrog steps with the CUDA kernel I: OPEN (g0) writes u1, v+1
    into ``scratch[0:2]``; MID (g1) reads u1 at the taps and writes u2 into
    ``out[0]`` and v+2 into ``scratch[2]``; CLOSE (g2) reads u2 at the taps
    and writes v2 into ``out[1]``. Nothing may alias (u0, v0) or another
    output."""
    check_lf_layout(layout, _off0(layout.p), "3p")
    if out is None:
        out = (torch.empty_like(u0), torch.empty_like(v0))
    if scratch is None:
        scratch = tuple(torch.empty_like(u0) for _ in range(3))
    u2, v2 = out
    u1, vplus1, vplus2 = scratch
    check_lf_operands(layout, st, w1, w2, u0=u0, v0=v0, u2=u2, v2=v2, u1=u1,
                      vplus1=vplus1, vplus2=vplus2)
    _cuda.check_no_alias((u2, v2, u1, vplus1, vplus2), (u0, v0))
    face = (layout, c0, st, w1, w2, src_x, abc_x)
    r_open, r_mid, r_close = phase_rings(layout, 3)
    launch_lf_phase(lf2_step_cuda, LF_OPEN, u0, v0, u1, vplus1, dt, g0, *face,
                    ring=r_open)
    launch_lf_phase(lf2_step_cuda, LF_MID, u1, vplus1, u2, vplus2, dt, g1, *face,
                    ring=r_mid)
    launch_lf_phase(lf2_step_cuda, LF_CLOSE, u2, vplus2, None, v2, dt, g2, *face,
                    ring=r_close)
    return u2, v2


#: process-wide count of kernel I launches (three per call of two steps;
#: diagnostics: shows that a run went through the kernel)
lf2_step_cuda.launches = 0
LAUNCHES_PER_CALL = 3


def lf2_step(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    g0: float,
    g1: float,
    g2: float,
    layout: PaddedLayout,
    c0: float,
    tables: LF2Tables,
    st: StencilTables,
    src_x: int,
    abc_x: int,
    out=None,
    scratch=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two leapfrog steps: plain version for CPU tensors, kernel I for CUDA
    ones (``out``/``scratch`` are the kernel's reusable buffers)."""
    if u0.device.type == "cpu":
        return lf2_step_plain(u0, v0, dt, g0, g1, g2, layout, c0, tables)
    if u0.device.type == "cuda":
        return lf2_step_cuda(u0, v0, dt, g0, g1, g2, layout, c0, st,
                             tables.W1, tables.W2, src_x, abc_x, out=out,
                             scratch=scratch)
    raise ValueError(f"no implementation of lf2_step for device {u0.device}")
