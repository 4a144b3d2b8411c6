"""One kick-drift-kick leapfrog step of the padded wave system (kernel H).

Port of ``wave_fenics_tpu.ops.pallas_lfstep``. With F(t, u) = A u +
c0^2 g(t) W1 on the source row and D = c0 W2 on the absorbing row
(``solvers/leapfrog.py``), one step is

    v+ = (v0 + dt/2 F(t, u0)) / (1 + dt/2 D),   u1 = u0 + dt v+
    v1 = (1 - dt/2 D) v+ + dt/2 F(t + dt, u1)

with F recomputed from u0 every step, as the TPU kernel does (two stencil
applies per step).

Implementations:

- :func:`lf_step_plain`: plain torch, mirroring ``_kernel_lf_step`` tile by
  tile (2p-deep slab windows, band-matrix x term, all 2(2p+1) rolled y/z
  taps summed in chunks of 9, the same tables);
- :func:`lf_step_cuda`: the hand-written CUDA kernel
  (``csrc/lf_tiled.cu::lf_phase_tiled_kernel``, the 2.5D tiled stencil with
  TMA plane loads on the tiling of ``tiling.tma_geometry``), two launches
  per step (OPEN, CLOSE).

On a value-halo layout (the distributed leapfrog's halo = 2p of neighbour
values) the plain version computes what the TPU kernel computes over the
whole padded plane; the kernel's phases write the interior grown by their
rings (:func:`phase_rings`: OPEN's u1 and v+ to depth p, where CLOSE reads
them) and zeros beyond. Both agree on the interior.

:func:`lf_step` dispatches on the tensor's device: CPU -> plain, CUDA ->
kernel (or raise).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..convert import as_table
from . import _cuda, tiling
from .rk4step import _TileStep
from .wave import (
    PaddedLayout,
    StencilTables,
    axis_cv_tables,
    check_stencil,
    stencil_args,
    tma_launch_geometry,
)

__all__ = [
    "LFTables",
    "build_lf_tables",
    "build_lf_tables_from_cv",
    "lf_step",
    "lf_step_plain",
    "lf_step_cuda",
    "lf_launch_args",
    "phase_rings",
    "LF_OPEN",
    "LF_MID",
    "LF_CLOSE",
]

#: phases of ``lf_phase_tiled_kernel`` (csrc/lf_tiled.cu::LfPhase)
LF_OPEN, LF_MID, LF_CLOSE = 0, 1, 2
#: the 2(2p+1) y/z roll terms are summed in chunks of this many (the TPU
#: kernels' ``yz_chunk``)
YZ_CHUNK = 9


def _off0(p: int) -> int:
    """Slab x-halo depth: >= 2p, 8-aligned (the TPU's 2D DMA sublane rule)."""
    return -(-2 * p // 8) * 8


def build_lf_tables(
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
    """Static tables of the leapfrog step: (WXB, WXC, CVY, CVZ, FX, SXS,
    SRC, ABC, W1, W2) — the RK4 step's table semantics with the leapfrog's
    two window shapes and 2p slab halo."""
    cvx, cvy, cvz, pLx, pLy, pLz = axis_cv_tables(
        layout, A, lines, coeff, inv_m_lines
    )
    return build_lf_tables_from_cv(
        layout, cvx, cvy, cvz, pLx, pLy, pLz,
        w1_flat, w2_flat, src_x, abc_x, dtype,
    )


def build_lf_tables_from_cv(
    layout: PaddedLayout,
    cvx: np.ndarray, cvy: np.ndarray, cvz: np.ndarray,
    pLx: np.ndarray, pLy: np.ndarray, pLz: np.ndarray,
    w1_flat: np.ndarray,
    w2_flat: np.ndarray,
    src_x: int,
    abc_x: int,
    dtype=np.float32,
) -> tuple[np.ndarray, ...]:
    """Leapfrog step tables from pre-built padded coefficient/line vectors."""
    p = layout.p
    Tx = layout.tile_x
    Lx, Ly, Lz = layout.padded_shape
    K = 2 * p + 1
    off0 = _off0(p)
    S0 = Tx + 2 * off0
    F = Ly * Lz

    ntiles = Lx // Tx
    o1, o0 = off0 - p, off0
    shapes = [(o1, Tx + 2 * p), (o0, Tx)]
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
    WXB, WXC = bands

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
    return (WXB, WXC, CVY, CVZ, FX,
            *(as_table(t, dtype) for t in (SXS, SRC, ABC)), W1, W2)


class LFTables(NamedTuple):
    """Tensors of :func:`build_lf_tables`."""

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


def check_lf_layout(layout: PaddedLayout, off0: int, halo: str) -> None:
    """Raise unless the leapfrog kernels' slab halo ``off0`` fits the tile."""
    layout.check_flat()
    if layout.tile_x < off0:
        raise ValueError(
            f"tile_x = {layout.tile_x} must be >= {off0} (the {halo}-deep "
            "slab halo must stay inside the all-pad x tiles)"
        )


class LeapfrogTerms:
    """The force and damping of the plain leapfrog versions, in the TPU
    kernels' order: F = A u + (c0^2 g) (SRC W1) and D = c0 (ABC W2) on a
    tile's slab rows [o, o + nrows)."""

    def __init__(self, ts: _TileStep, c0: float):
        self.ts = ts
        self.pc0 = ts.sc(c0)
        self.one = ts.sc(1.0)
        self.dt2 = ts.dt * ts.half

    def force(self, t, au, gj, o, nrows):
        tb = self.ts.tb
        return au + (self.ts.c0sq * gj) * (tb.SRC[t, o : o + nrows] * tb.W1)

    def damp(self, t, o, nrows):
        tb = self.ts.tb
        return self.pc0 * (tb.ABC[t, o : o + nrows] * tb.W2)

    def apply_A(self, t, xin, wx, o, nrows):
        return self.ts.apply_A(t, xin, wx, o, nrows, False, YZ_CHUNK)


def lf_step_plain(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    g0: float,
    g1: float,
    layout: PaddedLayout,
    c0: float,
    tables: LFTables,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One leapfrog step on padded [Lx, Ly, Lz] states, mirroring
    ``_kernel_lf_step`` tile by tile (g0 = g(t), g1 = g(t + dt)); the
    all-pad tiles are zeros. A bf16 step runs in float32 and rounds where
    kernel H's phases store: v+ and u1 (formed from v+ as stored) in OPEN,
    v1 and u1 at the end."""
    p = layout.p
    check_lf_layout(layout, _off0(p), "2p")
    ts = _TileStep(u0, v0, dt, (g0, g1), layout, c0, LFTables(*tables), _off0(p))
    lt = LeapfrogTerms(ts, c0)
    tb, Tx = ts.tb, layout.tile_x
    o1, o0 = _off0(p) - p, _off0(p)
    n1, n0 = Tx + 2 * p, Tx
    dt_, dt2, one = ts.dt, lt.dt2, lt.one
    u1, v1 = ts.new_state()
    for t, U0, V0 in ts.tiles():
        # half-kick (implicit) + drift on the p-deep window
        F0 = lt.force(t, lt.apply_A(t, U0[o1 - p : o1 - p + n1 + 2 * p], tb.WXB,
                                    o1, n1), ts.g[0], o1, n1)
        vplus = ts.stored((V0[o1 : o1 + n1] + dt2 * F0)
                          / (one + dt2 * lt.damp(t, o1, n1)))
        u1w = ts.stored(U0[o1 : o1 + n1] + dt_ * vplus)
        # second (explicit) half-kick on the output rows
        F1 = lt.force(t, lt.apply_A(t, u1w, tb.WXC, o0, n0), ts.g[1], o0, n0)
        s = o0 - o1
        rows = ts.out_rows(t)
        v1[rows] = (one - dt2 * lt.damp(t, o0, n0)) * vplus[s : s + n0] + dt2 * F1
        u1[rows] = u1w[s : s + n0]
    return ts.finish(u1, v1)


def phase_rings(layout: PaddedLayout, phases: int) -> tuple[int, ...]:
    """The rings of a call's ``phases`` phase launches (kernel H: OPEN,
    CLOSE; kernel I: OPEN, MID, CLOSE) on ``layout``: all 0 on one device;
    on a value-halo layout phase k writes to depth (phases - 1 - k) p, the
    depth at which the next phase reads its u at the taps, so the halo must
    be phases x p deep."""
    p = layout.p
    if not layout.value_halo:
        return (0,) * phases
    if layout.h < phases * p:
        raise ValueError(f"a value halo of {layout.h} < {phases}p = {phases * p}: "
                         f"{phases} leapfrog phases read u {phases}p deep")
    return tuple((phases - 1 - k) * p for k in range(phases))


def lf_launch_args(
    phase: int, u: torch.Tensor, v: torch.Tensor, u_out: torch.Tensor | None,
    v_out: torch.Tensor, dt: float, g: float, layout: PaddedLayout, c0: float,
    st: StencilTables, w1: torch.Tensor, w2: torch.Tensor, src_x: int, abc_x: int,
    ring: int = 0,
) -> tuple:
    """The arguments of the C launcher ``wave_lf_phase_tiled`` (kernels H
    and I) up to the stream: the phase, the fields (``u_out`` None in
    CLOSE), the face planes and rows, the scalars, the stencil on the
    interior grown by ``ring`` (:func:`phase_rings`), then the tiling of
    ``tiling.tma_geometry`` (``fields=1, extra=0``: one TMA box of u a
    plane) of that box on this card and ``tiling.tma_padding_first``."""
    grid, ty, tz, cx, smem = tma_launch_geometry(u, layout, 1, 0, box_ring=ring)
    tiling.check_tma_launch(layout, u.element_size(), ty, tz, smem, ring)
    sms = tiling.sm_count(u.device.index) if u.is_cuda else tiling.H100_SMS
    first = tiling.tma_padding_first(grid, u.element_size(), sms)
    return (phase, u, v, 0 if u_out is None else u_out, v_out, w1, w2, int(src_x),
            int(abc_x), float(dt), float(g), float(c0),
            *stencil_args(layout, st, ring), ty, tz, cx, *grid, smem, int(first))


def launch_lf_phase(
    kernel, phase: int, u: torch.Tensor, v: torch.Tensor,
    u_out: torch.Tensor | None, v_out: torch.Tensor, dt: float, g: float,
    layout: PaddedLayout, c0: float, st: StencilTables, w1: torch.Tensor,
    w2: torch.Tensor, src_x: int, abc_x: int, ring: int = 0,
) -> None:
    """One launch of ``lf_phase_tiled_kernel`` (kernels H and I; operands
    checked by the caller) over the interior grown by ``ring``; adds one to
    ``kernel.launches``. CLOSE writes v_out only (``u_out`` None)."""
    _cuda.launch("wave_lf_phase_tiled", u.dtype, u.device, *lf_launch_args(
        phase, u, v, u_out, v_out, dt, g, layout, c0, st, w1, w2, src_x, abc_x,
        ring))
    kernel.launches += 1


def check_lf_operands(layout, st, w1, w2, **fields) -> None:
    """Check the state-sized ``fields`` and the stencil and facet planes of
    a leapfrog kernel on the first field's device and dtype."""
    shape = layout.padded_shape
    F = shape[1] * shape[2]
    first = next(iter(fields.values()))
    dev, dtype = first.device, first.dtype
    _cuda.check_operands(
        dev, dtype, w1=(w1, (1, F)), w2=(w2, (1, F)),
        **{k: (t, shape) for k, t in fields.items()},
    )
    check_stencil(layout, st, dev, dtype)


def lf_step_cuda(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    g0: float,
    g1: float,
    layout: PaddedLayout,
    c0: float,
    st: StencilTables,
    w1: torch.Tensor,
    w2: torch.Tensor,
    src_x: int,
    abc_x: int,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
    scratch: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One leapfrog step with the CUDA kernel H: OPEN writes u1 into
    ``out[0]`` and v+ into ``scratch``, CLOSE reads u1 at the taps and
    writes v1 into ``out[1]``. ``w1``/``w2`` are the [1, F] facet planes,
    ``src_x``/``abc_x`` their padded x rows. The outputs and the scratch
    must not alias (u0, v0) or each other."""
    check_lf_layout(layout, _off0(layout.p), "2p")
    if out is None:
        out = (torch.empty_like(u0), torch.empty_like(v0))
    if scratch is None:
        scratch = torch.empty_like(u0)
    u1, v1 = out
    check_lf_operands(layout, st, w1, w2, u0=u0, v0=v0, u1=u1, v1=v1,
                      vplus=scratch)
    _cuda.check_no_alias((u1, v1, scratch), (u0, v0))
    face = (layout, c0, st, w1, w2, src_x, abc_x)
    r_open, r_close = phase_rings(layout, 2)
    launch_lf_phase(lf_step_cuda, LF_OPEN, u0, v0, u1, scratch, dt, g0, *face,
                    ring=r_open)
    launch_lf_phase(lf_step_cuda, LF_CLOSE, u1, scratch, None, v1, dt, g1, *face,
                    ring=r_close)
    return u1, v1


#: process-wide count of kernel H launches (two per step; diagnostics:
#: shows that a run went through the kernel)
lf_step_cuda.launches = 0
LAUNCHES_PER_STEP = 2


def lf_step(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    g0: float,
    g1: float,
    layout: PaddedLayout,
    c0: float,
    tables: LFTables,
    st: StencilTables,
    src_x: int,
    abc_x: int,
    out=None,
    scratch=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One leapfrog step: plain version for CPU tensors, kernel H for CUDA
    ones (``out``/``scratch`` are the kernel's reusable buffers)."""
    if u0.device.type == "cpu":
        return lf_step_plain(u0, v0, dt, g0, g1, layout, c0, tables)
    if u0.device.type == "cuda":
        return lf_step_cuda(u0, v0, dt, g0, g1, layout, c0, st, tables.W1,
                            tables.W2, src_x, abc_x, out=out, scratch=scratch)
    raise ValueError(f"no implementation of lf_step for device {u0.device}")
