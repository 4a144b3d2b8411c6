"""Two full-tableau RK4 steps per call of the padded wave system (kernel J).

Port of ``wave_fenics_tpu.ops.pallas_rk42step``: two classic RK4 steps with
the full Butcher tableau (``substep`` twice, ``pallas_rk42step.py:192-246``),
stage times t + {0, 1/2, 1/2, 1} dt and then t + {1, 3/2, 3/2, 2} dt, so the
source is sampled at the five times t + {0, 1/2, 1, 3/2, 2} dt (``gs``).

The TPU kernel keeps an x-slab with a 6p halo in VMEM and evaluates step 1
on a superset window, through six shrinking stage windows; those windows
and their band tables are a TPU device and are not ported. Here a launch
covers the whole grid, and two steps take seven launches instead of kernel
C's eight:

1-3. stages 0..2 of step 1 (kernel C's stage kernel,
     ``csrc/rk4_tiled.cu``, with TMA plane loads): kv0, kv1, kv2;
4.   the step boundary (``csrc/rk42_tiled.cu::rk42_boundary_tiled_kernel``,
     the 2.5D tiled stencil with TMA plane loads of u0, v0, kv0, kv1, kv2):
     kv3 of step 1, the full-tableau (u1, v1), and step 2's stage 0,
     kv0' = A u1 + faces at t + dt, with un3 and u1 formed once per point
     of each plane window (u1 does not depend on kv3);
5-7. stages 1..3 of step 2 from (u1, v1, kv0'): (u2, v2).

On a value-halo layout (``parallel/sharded_padded.py``: a halo of 6p
holding the neighbour blocks' values, refreshed once per call) each launch
writes the interior grown by its ring into the halo and zeros beyond it
(:func:`call_rings`), and reads the p-deep ring of values around its box as
they are in memory; the plain version computes the same boxes.

Implementations: :func:`rk42_step_plain` (plain torch, the same seven
phases on the stencil tables, ``ops.wave.apply_stencil_plain``; the fourth
is :func:`rk42_boundary_plain`) and
:func:`rk42_step_cuda` (the kernels, with ``.launches``; the checks
launch the boundary alone through :func:`_rk42_boundary_cuda`, which counts
no launch); :func:`rk42_step`
dispatches on the tensor's device: CPU -> plain, CUDA -> kernel (or raise).
"""

from __future__ import annotations

import torch

from ..convert import acc_dtype, stored, widen
from . import _cuda, tiling
from .rk4step import stage_launch_args
from .wave import (
    PaddedLayout,
    StencilTables,
    apply_stencil_plain,
    check_stencil,
    stencil_args,
    tma_launch_geometry,
)

__all__ = ["rk42_step", "rk42_step_plain", "rk42_step_cuda", "rk42_boundary_plain",
           "boundary_launch_args", "boundary_ring", "call_rings", "LAUNCHES_PER_CALL"]

_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
#: the step-boundary kernel's TMA input fields a plane (u0, v0, kv0, kv1,
#: kv2) and its formed planes (un3 and u1, two of each)
BOUNDARY_FIELDS, BOUNDARY_EXTRA = 5, 4


def boundary_ring(itemsize: int) -> int:
    """Planes in the step-boundary kernel's TMA ring
    (``csrc/rk42_tiled.cu::boundary_ring<T>``): two in f64, three in f32
    and bf16, so that five boxes a plane leave room for the blocks an SM
    holds."""
    return 2 if itemsize == 8 else 3


def _off0(p: int) -> int:
    """Slab x-halo depth of the TPU kernel: >= 6p (two chained 3p stage
    recursions), 8-aligned. Kept as the JAX package's applicability rule,
    so both packages take the 2-step path on the same configurations."""
    return -(-6 * p // 8) * 8


def _check_layout(layout: PaddedLayout) -> None:
    layout.check_flat()
    if layout.tile_x < _off0(layout.p):
        raise ValueError(
            f"tile_x = {layout.tile_x} < the 6p slab halo {_off0(layout.p)}")


def call_rings(layout: PaddedLayout) -> tuple[tuple[int, ...], int]:
    """(the rings of a call's seven launches, the load ring) of kernel J on
    ``layout``. One device: all 0 (the interior, zero padding around it).
    A value-halo layout: a full-tableau stage j reads kv_{j-2} at its taps
    and kv_{j-1} only at the point, and the boundary's kv0' reads u1 at its
    taps. Step 2's output on the interior then needs step 2's kv1' to p and
    its kv2' on the interior (launches 5-7 write p, 0, 0), (u1, v1) to 2p
    and kv0' to p (the boundary writes all three to 2p; kv0' is exact to
    p); the boundary needs kv0 and kv2 to 2p and kv1 to 3p, so step 1's
    stages write kv0, kv1 to 3p and kv2 to 2p. Every launch reads the
    p-deep ring of values around its box, so a call's result depends on
    (u0, v0) within 4p of a point: the halo must be at least 4p deep (the
    JAX package takes 6p)."""
    p = layout.p
    if not layout.value_halo:
        return (0,) * LAUNCHES_PER_CALL, 0
    if layout.h < 4 * p:
        raise ValueError(f"a value halo of {layout.h} < 4p = {4 * p}: two RK4 "
                         "steps read (u0, v0) 4p deep")
    return (3 * p, 3 * p, 2 * p, 2 * p, p, 0, 0), p


def _masked(x: torch.Tensor, layout: PaddedLayout, ring: int) -> torch.Tensor:
    """x on the interior grown by ``ring`` (``PaddedLayout.box``), 0 beyond."""
    x0, nx, h, ny, nz = layout.box(ring)
    out = torch.zeros_like(x)
    out[x0 : x0 + nx, h : h + ny, h : h + nz] = x[x0 : x0 + nx, h : h + ny, h : h + nz]
    return out


def _phases(like: torch.Tensor, dt: float, layout: PaddedLayout, c0: float,
            st: StencilTables, w1: torch.Tensor, w2: torch.Tensor, src_x: int,
            abc_x: int):
    """(kv_of, stage, combine) of the plain version on ``like``'s device, in
    its arithmetic type (``convert.acc_dtype``: float32 for a bf16 state,
    as kernel C's stages and the boundary kernel compute), on fields in that
    type: kv_of(un, vn, g, ring=0, store=True) = A un + c0^2 g W1 - c0 W2 vn
    (the face terms on their rows) on the interior grown by ``ring``, 0
    beyond; stage(j, u, v, k0, k1, k2, g, ring=0, store=True), kernel C's
    stage j from (u, v) and the earlier stages' kv, its input un rounded as
    the kernel stores it in its plane ring; combine(u, v, k0, k1, k2, k3),
    the full-tableau (u1, v1) at every point. ``store``: the kv rounded as
    the kernel stores it (a bf16 state's only; kv3 is never stored)."""
    Lx = layout.padded_shape[0]
    dtype = like.dtype
    st = StencilTables(*widen(*st))
    w1, w2 = widen(w1, w2)
    sc = lambda x: torch.tensor(x, dtype=acc_dtype(dtype), device=like.device)  # noqa: E731
    rnd = lambda x: stored(x, dtype)  # noqa: E731
    dt_ = sc(dt)
    a = sc(0.5) * dt_
    c0sq, mc0 = sc(c0 * c0), sc(-c0)
    b0, b1 = sc(_B[0]), sc(_B[1])

    def kv_of(un, vn, g, ring=0, store=True):
        kv = apply_stencil_plain(un, layout, st, ring)
        k2, vn2 = kv.view(Lx, -1), vn.reshape(Lx, -1)
        k2[src_x] += (c0sq * sc(g)) * w1[0]
        k2[abc_x] += (mc0 * w2[0]) * vn2[abc_x]
        kv = _masked(kv, layout, ring)
        return rnd(kv) if store else kv

    def stage(j, u, v, k0, k1, k2, g, ring=0, store=True):
        if j == 1:
            return kv_of(rnd(u + a * v), v + a * k0, g, ring, store)
        if j == 2:
            return kv_of(rnd(u + a * (v + a * k0)), v + a * k1, g, ring, store)
        return kv_of(rnd(u + dt_ * (v + a * k1)), v + dt_ * k2, g, ring, store)

    def combine(u, v, k0, k1, k2, k3):
        vn1, vn2, vn3 = v + a * k0, v + a * k1, v + dt_ * k2
        accu = ((b0 * v + b1 * vn1) + b1 * vn2) + b0 * vn3
        accv = ((b0 * k0 + b1 * k1) + b1 * k2) + b0 * k3
        return u + dt_ * accu, v + dt_ * accv

    return kv_of, stage, combine


def _boundary(phases, dtype, u0, v0, kv0, kv1, kv2, g, ring):
    """The step boundary on fields in the arithmetic type: kv3 (never
    stored), (u1, v1) rounded as stored, and kv0' from them."""
    kv_of, stage, combine = phases
    kv3 = stage(3, u0, v0, kv0, kv1, kv2, g, ring, store=False)
    u1, v1 = (stored(x, dtype) for x in combine(u0, v0, kv0, kv1, kv2, kv3))
    return u1, v1, kv_of(u1, v1, g, ring)


def rk42_boundary_plain(
    u0: torch.Tensor,
    v0: torch.Tensor,
    kv0: torch.Tensor,
    kv1: torch.Tensor,
    kv2: torch.Tensor,
    dt: float,
    g: float,
    layout: PaddedLayout,
    c0: float,
    st: StencilTables,
    w1: torch.Tensor,
    w2: torch.Tensor,
    src_x: int,
    abc_x: int,
    ring: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step boundary, the fourth of :func:`rk42_step_cuda`'s launches
    (the plain version of ``rk42_boundary_tiled_kernel``): from step 1's
    (u0, v0) and stages kv0..kv2 at ``g`` = g(t + dt), step 1's kv3, its
    full-tableau (u1, v1) and step 2's stage 0, kv0' = A u1 + faces, on
    the interior grown by ``ring`` and 0 beyond. kv0' reads at its taps the
    u1 formed from the inputs as they are in memory, as the kernel forms
    it in its plane windows. A bf16 state runs in float32 and rounds where
    the kernel stores: un3, u1 and v1 (kv0' from them as stored), kv0'.
    Returns (u1, v1, kv0')."""
    _check_layout(layout)
    dtype = u0.dtype
    phases = _phases(u0, dt, layout, c0, st, w1, w2, src_x, abc_x)
    u1, v1, kv0n = _boundary(phases, dtype, *widen(u0, v0, kv0, kv1, kv2), g, ring)
    return (_masked(u1, layout, ring).to(dtype), _masked(v1, layout, ring).to(dtype),
            kv0n.to(dtype))


def rk42_step_plain(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    gs: tuple[float, float, float, float, float],
    layout: PaddedLayout,
    c0: float,
    st: StencilTables,
    w1: torch.Tensor,
    w2: torch.Tensor,
    src_x: int,
    abc_x: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two full-tableau RK4 steps on padded [Lx, Ly, Lz] states, as the
    seven phases of :func:`rk42_step_cuda`, each on the box of
    :func:`call_rings`; ``w1``/``w2`` are the [1, F] facet planes,
    ``src_x``/``abc_x`` their padded x rows (-1 where the layout holds no
    such face). A bf16 state runs in float32 and rounds where the seven
    launches store (kernel C's stage inputs and kv, the boundary's)."""
    _check_layout(layout)
    rings, _ = call_rings(layout)
    face = (layout, c0, st, w1, w2, src_x, abc_x)
    dtype = u0.dtype
    phases = _phases(u0, dt, *face)
    kv_of, stage, combine = phases
    u0, v0 = widen(u0, v0)
    # step 1: stages 0..2, then the boundary: kv3, (u1, v1) and step 2's kv0
    kv0 = kv_of(u0, v0, gs[0], rings[0])
    kv1 = stage(1, u0, v0, kv0, None, None, gs[1], rings[1])
    kv2 = stage(2, u0, v0, kv0, kv1, None, gs[1], rings[2])
    u1, v1, kv0 = _boundary(phases, dtype, u0, v0, kv0, kv1, kv2, gs[2], rings[3])
    u1, v1 = _masked(u1, layout, rings[3]), _masked(v1, layout, rings[3])
    # step 2: stages 1..3
    kv1 = stage(1, u1, v1, kv0, None, None, gs[3], rings[4])
    kv2 = stage(2, u1, v1, kv0, kv1, None, gs[3], rings[5])
    kv3 = stage(3, u1, v1, kv0, kv1, kv2, gs[4], rings[6], store=False)
    u2, v2 = combine(u1, v1, kv0, kv1, kv2, kv3)
    return (_masked(u2, layout, rings[6]).to(dtype),
            _masked(v2, layout, rings[6]).to(dtype))


def boundary_launch_args(
    u0, v0, kv0, kv1, kv2, u1, v1, kv0_out, w1, w2, src_x: int, abc_x: int,
    dt: float, g: float, c0: float, layout: PaddedLayout, st: StencilTables,
    ring: int = 0,
) -> tuple:
    """The arguments of the C launcher ``wave_rk42_boundary_tiled`` (kernel
    J's step boundary) up to the stream: the fields, the face planes and
    rows, the scalars (``g`` = g(t + dt)), the stencil on the interior
    grown by ``ring`` (:func:`call_rings`), then the tiling of
    ``tiling.tma_geometry`` (``fields=5, extra=4``, a ring of
    :func:`boundary_ring` planes) of that box on this card. The kernel's
    TMA windows read the p-deep ring around its box as it is in memory.
    Raises a ValueError naming the condition a layout the kernel cannot
    tile breaks."""
    itemsize = u0.element_size()
    grid, ty, tz, cx, smem = tma_launch_geometry(
        u0, layout, BOUNDARY_FIELDS, BOUNDARY_EXTRA, boundary_ring(itemsize),
        box_ring=ring)
    tiling.check_tma_launch(layout, itemsize, ty, tz, smem, ring)
    return (u0, v0, kv0, kv1, kv2, u1, v1, kv0_out, w1, w2, int(src_x), int(abc_x),
            float(dt), float(g), float(c0), *stencil_args(layout, st, ring),
            ty, tz, cx, *grid, smem)


def _launch_boundary(u0, v0, kv0, kv1, kv2, u1, v1, kv0_out, dt, g, layout, c0, st,
                     w1, w2, src_x, abc_x, ring=0) -> None:
    """One launch of the step-boundary kernel over the interior grown by
    ``ring`` (operands checked by the caller)."""
    _cuda.launch("wave_rk42_boundary_tiled", u0.dtype, u0.device, *boundary_launch_args(
        u0, v0, kv0, kv1, kv2, u1, v1, kv0_out, w1, w2, src_x, abc_x, dt, g, c0,
        layout, st, ring))


def _rk42_boundary_cuda(
    u0: torch.Tensor,
    v0: torch.Tensor,
    kv0: torch.Tensor,
    kv1: torch.Tensor,
    kv2: torch.Tensor,
    dt: float,
    g: float,
    layout: PaddedLayout,
    c0: float,
    st: StencilTables,
    w1: torch.Tensor,
    w2: torch.Tensor,
    src_x: int,
    abc_x: int,
    out: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    ring: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel J's step boundary alone, for the checks that hold it against
    :func:`rk42_boundary_plain` (one launch of
    ``rk42_boundary_tiled_kernel``, counted nowhere: on the solver paths
    the boundary runs inside :func:`rk42_step_cuda`): (u1, v1, kv0'),
    every padded point written, 0 outside the interior grown by ``ring``.
    ``out`` = (u1, v1, kv0') is reused when given; none of them may alias
    an input or each other."""
    _check_layout(layout)
    shape = layout.padded_shape
    F = shape[1] * shape[2]
    dev, dtype = u0.device, u0.dtype
    if out is None:
        out = tuple(torch.empty_like(u0) for _ in range(3))
    ins = (u0, v0, kv0, kv1, kv2)
    _cuda.check_operands(
        dev, dtype, w1=(w1, (1, F)), w2=(w2, (1, F)),
        **{f"in{j}": (x, shape) for j, x in enumerate(ins)},
        **{f"out{j}": (x, shape) for j, x in enumerate(out)},
    )
    check_stencil(layout, st, dev, dtype)
    _cuda.check_no_alias(out, ins)
    _launch_boundary(*ins, *out, dt, g, layout, c0, st, w1, w2, src_x, abc_x, ring)
    return out


def rk42_step_cuda(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    gs: tuple[float, float, float, float, float],
    layout: PaddedLayout,
    c0: float,
    st: StencilTables,
    w1: torch.Tensor,
    w2: torch.Tensor,
    src_x: int,
    abc_x: int,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
    scratch: tuple[torch.Tensor, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two full-tableau RK4 steps with the CUDA kernel J: seven launches,
    each over the box of :func:`call_rings` and adding one to
    ``rk42_step_cuda.launches`` (kernel C's count does not move; the fourth
    is the step boundary, so a call's boundary launches are its count over
    LAUNCHES_PER_CALL). ``out`` = (u2, v2) and
    ``scratch`` = (kv0, kv1, kv2, u1, v1, kv0') are reused when given; none
    of them may alias (u0, v0) or each other."""
    _check_layout(layout)
    shape = layout.padded_shape
    F = shape[1] * shape[2]
    dev, dtype = u0.device, u0.dtype
    if out is None:
        out = (torch.empty_like(u0), torch.empty_like(v0))
    if scratch is None:
        scratch = tuple(torch.empty_like(u0) for _ in range(6))
    u2, v2 = out
    kv0, kv1, kv2, u1, v1, kv0n = scratch
    _cuda.check_operands(
        dev, dtype,
        u0=(u0, shape), v0=(v0, shape), u2=(u2, shape), v2=(v2, shape),
        kv0=(kv0, shape), kv1=(kv1, shape), kv2=(kv2, shape), u1=(u1, shape),
        v1=(v1, shape), kv0n=(kv0n, shape), w1=(w1, (1, F)), w2=(w2, (1, F)),
    )
    check_stencil(layout, st, dev, dtype)
    _cuda.check_no_alias((u2, v2, *scratch), (u0, v0))
    face = (w1, w2, int(src_x), int(abc_x), float(dt))
    rings, _ = call_rings(layout)

    def stage(j, u, v, k0, k_out, g, ring):
        # kernel C's stage j; stages 0..2 write k_out, stage 3 writes (u2, v2)
        _cuda.launch("wave_rk4_full_stage", dtype, dev, *stage_launch_args(
            j, u, v, k0, kv1, kv2, k_out, u2, v2, *face, g, c0, layout, st,
            ring=ring))
        rk42_step_cuda.launches += 1

    stage(0, u0, v0, kv0, kv0, gs[0], rings[0])
    stage(1, u0, v0, kv0, kv1, gs[1], rings[1])
    stage(2, u0, v0, kv0, kv2, gs[1], rings[2])
    _launch_boundary(u0, v0, kv0, kv1, kv2, u1, v1, kv0n, dt, gs[2], c0=c0,
                     layout=layout, st=st, w1=w1, w2=w2, src_x=src_x, abc_x=abc_x,
                     ring=rings[3])
    rk42_step_cuda.launches += 1
    stage(1, u1, v1, kv0n, kv1, gs[3], rings[4])
    stage(2, u1, v1, kv0n, kv2, gs[3], rings[5])
    stage(3, u1, v1, kv0n, kv2, gs[4], rings[6])
    return u2, v2


#: process-wide count of kernel J launches (seven per call of two steps;
#: diagnostics: shows that a run went through the kernel)
rk42_step_cuda.launches = 0
LAUNCHES_PER_CALL = 7


def rk42_step(
    u0: torch.Tensor,
    v0: torch.Tensor,
    dt: float,
    gs: tuple[float, float, float, float, float],
    layout: PaddedLayout,
    c0: float,
    st: StencilTables,
    w1: torch.Tensor,
    w2: torch.Tensor,
    src_x: int,
    abc_x: int,
    out=None,
    scratch=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two full-tableau RK4 steps: plain version for CPU tensors, kernel J
    for CUDA ones (``out``/``scratch`` are the kernel's reusable buffers)."""
    if u0.device.type == "cpu":
        return rk42_step_plain(u0, v0, dt, gs, layout, c0, st, w1, w2,
                               src_x, abc_x)
    if u0.device.type == "cuda":
        return rk42_step_cuda(u0, v0, dt, gs, layout, c0, st, w1, w2, src_x,
                              abc_x, out=out, scratch=scratch)
    raise ValueError(f"no implementation of rk42_step for device {u0.device}")
