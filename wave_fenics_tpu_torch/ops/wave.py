"""Padded-state wave stencil: stiffness/m in one pass on the padded layout.

Port of ``wave_fenics_tpu.ops.pallas_wave`` (flat layout). The solver state
lives permanently in the aligned padded layout (``PaddedLayout``, kept
exactly as the JAX package defines it so padded states compare element by
element); 1/m folds into the static line scalings, so one application
returns the stiffness part of dv/dt = -c0^2 (K u)/m.

Two implementations of ``y = A x`` (kernel B):

- :func:`apply_flat_plain`: plain torch, mirroring the TPU kernel
  ``_kernel_flat`` tile by tile (x term as the per-tile band matrix
  ``WXT``, y/z terms as rolls of the flattened (y, z) plane, the same
  tables and roll order);
- :func:`apply_flat_cuda`: the hand-written CUDA kernel
  (``csrc/flat_tiled.cu::apply_flat_tiled_kernel``, on the TMA tiling of
  ``tiling.tma_geometry``), which reads the banded x coefficients ``cvx``
  directly instead of a band matrix (:func:`stencil_tables`), in the sum
  order of :func:`apply_stencil_plain`.

and of one stage of the fused-stage RK4 path (kernel D, the TPU kernel
``_kernel_rk_stage``): :func:`rk_stage_plain` and :func:`rk_stage_cuda`
(``csrc/rk_stage_tiled.cu::rk_stage_tiled_kernel``, on the TMA tiling of
``tiling.tma_geometry``).

The same ``y = A x`` on the 3D-slab layout (z aligned to 128; the layout
the JAX package takes for p > 8 or ``kernel='3d'``), kernel E, the TPU
kernel ``_kernel``: :func:`build_tables` (its tables, tap form),
:func:`apply_slab_plain` (plain torch, mirroring ``_kernel`` tile by tile)
and :func:`apply_slab_cuda` (``csrc/slab_tiled.cu::apply_slab_tiled_kernel``,
on the TMA tiling of ``tiling.tma_geometry``).

:func:`apply_stencil_plain` is the plain version of the stencil the
flat-layout CUDA kernels share (``csrc/stencil.cuh``'s tables, in the sum
order of ``csrc/stencil_tiled.cuh``), on the whole padded state.

Kernels B, D and E and their plain versions also take a bf16 state (bf16
tables, float32 arithmetic, one rounding where the kernel stores); the
builders compute bf16 tables in float64 (``convert.as_table``).

:func:`apply_flat`, :func:`apply_slab` and :func:`rk_stage` dispatch on the
tensor's device: CPU -> plain, CUDA -> kernel (or raise). There is no
fallback between them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..convert import as_table, stored, widen
from . import _cuda, tiling
from .stiffness import banded_1d_coeffs

__all__ = [
    "PaddedLayout",
    "FlatTables",
    "SlabTables",
    "StencilTables",
    "axis_cv_tables",
    "build_tables",
    "build_tables_flat",
    "stencil_tables",
    "stencil_tables_from_cv",
    "apply_flat",
    "apply_flat_plain",
    "apply_flat_cuda",
    "flat_launch_args",
    "apply_slab",
    "apply_slab_plain",
    "apply_slab_cuda",
    "slab_launch_args",
    "apply_stencil_plain",
    "rk_stage",
    "rk_stage_plain",
    "rk_stage_cuda",
    "rk_stage_launch_args",
]


def _r8(n):
    return -(-n // 8) * 8


@dataclass(frozen=True)
class PaddedLayout:
    """Aligned padded storage for a dof grid [Nx, Ny, Nz].

    Interior at offset (tile_x, h, h); padded dims:
    x = (ceil(Nx/tile_x) + 2) * tile_x, y = r8(Ny + 2h), and z rounded
    to ``z_align``. The alignments are the TPU's DMA rules, kept so that
    padded states match the JAX package's element for element.

    ``halo`` defaults to p (one device: zero padding the stencils fall
    off). The distributed value-halo layouts (``parallel/sharded_padded.py``)
    take halo = 3p (RK4 step, 2-step leapfrog) or 2p (leapfrog step): the
    halo then holds the neighbour blocks' values, exchanged once per kernel
    call, and the kernels also compute into it (:meth:`box`). The padding
    beyond the valid halo must stay zero; operators preserve this invariant.
    """

    shape: tuple[int, int, int]
    p: int
    tile_x: int = 16
    z_align: int = 128
    halo: int | None = None

    @property
    def h(self) -> int:
        """y/z padding depth: p, or ``halo`` where given."""
        return self.p if self.halo is None else self.halo

    @property
    def value_halo(self) -> bool:
        """Whether the halo is deeper than the stencil's reach: a
        distributed layout whose halo carries neighbour values."""
        return self.h > self.p

    def box(self, ring: int = 0) -> tuple[int, int, int, int, int]:
        """(x0, nx, h, ny, nz) of the interior grown by ``ring`` points on
        every side: the output box of a kernel launch that also writes
        that deep into the halo (0: the interior)."""
        Nx, Ny, Nz = self.shape
        if ring < 0 or ring > self.h - self.p or ring > self.x0 - self.p:
            raise ValueError(f"ring {ring}: a launch box grows at most h - p = "
                             f"{self.h - self.p} into the halo")
        return (self.x0 - ring, Nx + 2 * ring, self.h - ring, Ny + 2 * ring,
                Nz + 2 * ring)

    @property
    def ntx(self) -> int:
        return -(-self.shape[0] // self.tile_x)

    @property
    def x0(self) -> int:
        return self.tile_x

    @property
    def padded_shape(self) -> tuple[int, int, int]:
        Nx, Ny, Nz = self.shape
        za = self.z_align
        h = self.h
        return (
            (self.ntx + 2) * self.tile_x,
            _r8(Ny + 2 * h),
            -(-(Nz + 2 * h) // za) * za,
        )

    @property
    def interior(self) -> tuple[slice, slice, slice]:
        Nx, Ny, Nz = self.shape
        h = self.h
        return (
            slice(self.x0, self.x0 + Nx),
            slice(h, h + Ny),
            slice(h, h + Nz),
        )

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros(self.padded_shape)
        out[self.interior] = x
        return out

    def unpad(self, xp: torch.Tensor) -> torch.Tensor:
        return xp[self.interior]

    def padded_line(self, vals: np.ndarray, axis: int) -> np.ndarray:
        """Embed a length-N axis line into the padded axis extent."""
        L = self.padded_shape[axis]
        off = self.x0 if axis == 0 else self.h
        out = np.zeros(L, dtype=np.asarray(vals).dtype)
        out[off : off + len(vals)] = vals
        return out

    def check_flat(self) -> None:
        """Raise unless the flat-layout kernels can run on this layout."""
        Lx, Ly, Lz = self.padded_shape
        if (Ly * Lz) % 128 != 0:
            raise ValueError(f"Ly*Lz = {Ly * Lz} must be a multiple of 128")
        if self.tile_x % 8 != 0:
            raise ValueError(f"tile_x = {self.tile_x} must be a multiple of 8")
        if self.p > 8:
            raise ValueError("the flat layout supports p <= 8 (8-deep halo window)")


def axis_cv_tables(
    layout: PaddedLayout,
    A: list[np.ndarray],
    lines: list[np.ndarray],
    coeff: float,
    inv_m_lines: list[np.ndarray] | None = None,
) -> tuple[np.ndarray, ...]:
    """Raw per-axis stencil/line tables shared by the flat-layout kernels:
    (cvx, cvy, cvz, sLx, sLy, sLz) — banded coefficient vectors [K, L_d]
    (face corrections + own-axis 1/m folded in) and the scaled lumped lines
    embedded in the padded extents."""
    Nx, Ny, Nz = layout.shape
    p = layout.p
    K = 2 * p + 1

    Lxl, Lyl, Lzl = lines
    if inv_m_lines is None:
        ix_, iy_, iz_ = np.ones(Nx), np.ones(Ny), np.ones(Nz)
    else:
        mx, my, mz = inv_m_lines
        ix_, iy_, iz_ = 1.0 / mx, 1.0 / my, 1.0 / mz
    sLx, sLy, sLz = Lxl * ix_, Lyl * iy_, Lzl * iz_

    pl_ = layout.padded_line

    def padded_cv(Ad, n, axis, own_inv):
        body = banded_1d_coeffs(Ad, n, p, scale=coeff) * own_inv[None, :]
        return np.stack([pl_(body[k], axis) for k in range(K)])

    cvx = padded_cv(A[0], Nx, 0, ix_)  # [K, Lx]
    cvy = padded_cv(A[1], Ny, 1, iy_)  # [K, Ly]
    cvz = padded_cv(A[2], Nz, 2, iz_)  # [K, Lz]
    return cvx, cvy, cvz, pl_(sLx, 0), pl_(sLy, 1), pl_(sLz, 2)


def build_tables(
    layout: PaddedLayout,
    A: list[np.ndarray],
    lines: list[np.ndarray],
    coeff: float,
    inv_m_lines: list[np.ndarray] | None = None,
    dtype=np.float32,
) -> tuple[np.ndarray, ...]:
    """(LYZ, LXZ, LXY, CVX, CVY, CVZ) of the TPU 3D-slab kernel (kernel E)
    in its tap form: the three 2D line tables (the products of two scaled
    lumped lines, 1/m folded in) and the banded coefficients of each axis,
    shaped to broadcast against [Lx, Ly, Lz]. The JAX function's
    ``yz_matmul`` band matrices feed the TPU's matrix unit and are not
    copied; the taps compute the same terms."""
    p = layout.p
    Lx, Ly, Lz = layout.padded_shape
    K = 2 * p + 1
    cvx, cvy, cvz, pLx, pLy, pLz = axis_cv_tables(
        layout, A, lines, coeff, inv_m_lines
    )
    lyz = np.outer(pLy, pLz)
    lxz = np.einsum("x,z->xz", pLx, pLz)
    lxy = np.einsum("x,y->xy", pLx, pLy)
    return tuple(as_table(t, dtype) for t in (
        lyz[None],
        lxz[:, None, :],
        lxy[:, :, None],
        cvx.reshape(K, Lx, 1, 1),
        cvy.reshape(K, 1, Ly, 1),
        cvz.reshape(K, 1, 1, Lz),
    ))


def build_tables_flat(
    layout: PaddedLayout,
    A: list[np.ndarray],
    lines: list[np.ndarray],
    coeff: float,
    inv_m_lines: list[np.ndarray] | None = None,
    dtype=np.float32,
) -> tuple[np.ndarray, ...]:
    """(WXT, CVY, CVZ, FX, GZ, GY, SX) of the TPU flat kernel, the tables
    :func:`apply_flat_plain` runs on."""
    p = layout.p
    Tx = layout.tile_x
    Lx, Ly, Lz = layout.padded_shape
    K = 2 * p + 1
    span = Tx + 16
    F = Ly * Lz

    cvx, cvy, cvz, pLx, pLy, pLz = axis_cv_tables(
        layout, A, lines, coeff, inv_m_lines
    )

    ntiles = Lx // Tx
    WXT = np.zeros((ntiles, Tx, span))
    off = 8 - p  # slab row of the k=0 tap for out row o is o + (8 - p)
    for t in range(1, ntiles - 1):
        for o in range(Tx):
            g = t * Tx + o
            for k in range(K):
                WXT[t, o, o + off + k] = cvx[k, g]

    CVY = np.repeat(cvy, Lz, axis=1)  # [K, F], value depends on y = j // Lz
    CVZ = np.tile(cvz, (1, Ly))  # [K, F], value depends on z = j % Lz
    FX = np.outer(pLy, pLz).reshape(1, F)
    GZ = np.tile(pLz, Ly).reshape(1, F)
    GY = np.repeat(pLy, Lz).reshape(1, F)
    SX = pLx.reshape(Lx, 1)
    return tuple(as_table(t, dtype) for t in (WXT, CVY, CVZ, FX, GZ, GY, SX))


def stencil_tables(
    layout: PaddedLayout,
    A: list[np.ndarray],
    lines: list[np.ndarray],
    coeff: float,
    inv_m_lines: list[np.ndarray] | None = None,
    dtype=np.float32,
) -> tuple[np.ndarray, ...]:
    """(cvx [K, Lx], sx [Lx], fx [F], cvy [K, F], cvz [K, F]) of the CUDA
    stencil (``csrc/stencil.cuh``): the banded x coefficients as they are,
    and the y/z coefficients with the z/y lines folded in exactly as the TPU
    step kernel's tables fold them (``build_step_tables_from_cv``)."""
    return stencil_tables_from_cv(
        layout, *axis_cv_tables(layout, A, lines, coeff, inv_m_lines), dtype)


def stencil_tables_from_cv(
    layout: PaddedLayout,
    cvx: np.ndarray, cvy: np.ndarray, cvz: np.ndarray,
    pLx: np.ndarray, pLy: np.ndarray, pLz: np.ndarray,
    dtype=np.float32,
) -> tuple[np.ndarray, ...]:
    """:func:`stencil_tables` from padded coefficient and line vectors
    (those of :func:`axis_cv_tables`, or a block's slices of the global
    ones with their halo, ``parallel/sharded_padded.py``)."""
    Lx, Ly, Lz = layout.padded_shape
    F = Ly * Lz
    gz = np.tile(pLz, Ly).reshape(1, F)
    gy = np.repeat(pLy, Lz).reshape(1, F)
    return tuple(as_table(t, dtype) for t in (
        cvx, pLx, np.outer(pLy, pLz).reshape(F),
        np.repeat(cvy, Lz, axis=1) * gz, np.tile(cvz, (1, Ly)) * gy))


class FlatTables(NamedTuple):
    """Tensors of :func:`build_tables_flat` (plain version)."""

    WXT: torch.Tensor
    CVY: torch.Tensor
    CVZ: torch.Tensor
    FX: torch.Tensor
    GZ: torch.Tensor
    GY: torch.Tensor
    SX: torch.Tensor


class SlabTables(NamedTuple):
    """Tensors of :func:`build_tables` (kernel E and its plain version)."""

    LYZ: torch.Tensor  # [1, Ly, Lz]
    LXZ: torch.Tensor  # [Lx, 1, Lz]
    LXY: torch.Tensor  # [Lx, Ly, 1]
    CVX: torch.Tensor  # [K, Lx, 1, 1]
    CVY: torch.Tensor  # [K, 1, Ly, 1]
    CVZ: torch.Tensor  # [K, 1, 1, Lz]


class StencilTables(NamedTuple):
    """Tensors of :func:`stencil_tables` (CUDA kernels)."""

    cvx: torch.Tensor
    sx: torch.Tensor
    fx: torch.Tensor
    cvy: torch.Tensor
    cvz: torch.Tensor


def _check_no_tf32(x: torch.Tensor) -> None:
    # a plain version on the card is a reference: TF32 keeps ~3 digits
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.backends.cudnn.allow_tf32):
        raise RuntimeError(
            "plain version on a CUDA tensor with TF32 enabled: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.backends.cudnn.allow_tf32 = False"
        )


def apply_flat_plain(
    xp: torch.Tensor, layout: PaddedLayout, tables: FlatTables
) -> torch.Tensor:
    """y = A x on a padded [Lx, Ly, Lz] state, mirroring ``_kernel_flat``:
    per interior x-tile, the band-matrix x term on the 8-deep halo window,
    then the y and z roll terms; the two all-pad tiles are zeros. A bf16
    state and its tables are widened to float32 and the result rounded
    once, as kernel B stores it."""
    _check_no_tf32(xp)
    layout.check_flat()
    dtype = xp.dtype
    xp, WXT, CVY, CVZ, FX, GZ, GY, SX = widen(xp, *tables)
    p = layout.p
    Tx = layout.tile_x
    Lx, Ly, Lz = layout.padded_shape
    K = 2 * p + 1
    F = Ly * Lz
    span = Tx + 16
    x2 = xp.reshape(Lx, F)
    out = torch.zeros_like(x2)
    for t in range(1, Lx // Tx - 1):
        U = x2[t * Tx - 8 : t * Tx - 8 + span]
        o = (WXT[t] @ U) * FX
        Uc = U[8 : 8 + Tx]
        sx = SX[t * Tx : (t + 1) * Tx]
        acc = CVY[p][None, :] * Uc
        for k in range(K):
            if k != p:
                acc = acc + CVY[k][None, :] * torch.roll(Uc, ((p - k) * Lz) % F, 1)
        o = o + acc * (sx * GZ)
        acc = CVZ[p][None, :] * Uc
        for k in range(K):
            if k != p:
                acc = acc + CVZ[k][None, :] * torch.roll(Uc, (p - k) % F, 1)
        o = o + acc * (sx * GY)
        out[t * Tx : (t + 1) * Tx] = o
    return out.reshape(Lx, Ly, Lz).to(dtype)


def stencil_args(layout: PaddedLayout, st: StencilTables, ring: int = 0) -> tuple:
    """The stencil arguments of the C launchers (csrc/stencil.cuh order),
    the box the interior grown by ``ring`` (:meth:`PaddedLayout.box`)."""
    Lx, Ly, Lz = layout.padded_shape
    return (*st, layout.p, Lx, Ly, Lz, *layout.box(ring))


def check_stencil(layout: PaddedLayout, st: StencilTables, device, dtype) -> None:
    Lx, Ly, Lz = layout.padded_shape
    F = Ly * Lz
    K = 2 * layout.p + 1
    _cuda.check_operands(
        device, dtype,
        cvx=(st.cvx, (K, Lx)), sx=(st.sx, (Lx,)), fx=(st.fx, (F,)),
        cvy=(st.cvy, (K, F)), cvz=(st.cvz, (K, F)),
    )
    if layout.x0 < layout.p or layout.h < layout.p:
        raise ValueError("the padding must be at least p deep on every side")


def flat_launch_args(xp, out, layout: PaddedLayout, st: StencilTables) -> tuple:
    """The arguments of the C launcher ``wave_apply_flat_tiled`` (kernel B)
    up to the stream: x, y, the stencil, then the tiling of
    ``tiling.tma_geometry`` (``fields=1, extra=0``: one TMA box of x a
    plane) on this card. Raises a ValueError naming the condition a layout
    the kernel cannot tile breaks."""
    layout.check_flat()
    grid, ty, tz, cx, smem = tma_launch_geometry(xp, layout, 1, 0)
    tiling.check_tma_launch(layout, xp.element_size(), ty, tz, smem)
    return (xp, out, *stencil_args(layout, st), ty, tz, cx, *grid, smem)


def apply_flat_cuda(
    xp: torch.Tensor,
    layout: PaddedLayout,
    st: StencilTables,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = A x with the CUDA kernel B (one launch): every padded point
    written, 0 outside the interior, whatever ``out`` held. ``out``
    (optional) must not alias ``xp``."""
    layout.check_flat()
    shape = layout.padded_shape
    if out is None:
        out = torch.empty_like(xp)
    _cuda.check_operands(xp.device, xp.dtype, x=(xp, shape), y=(out, shape))
    check_stencil(layout, st, xp.device, xp.dtype)
    if out.data_ptr() == xp.data_ptr():
        raise ValueError("out must not alias the input")
    _cuda.launch("wave_apply_flat_tiled", xp.dtype, xp.device,
                 *flat_launch_args(xp, out, layout, st))
    apply_flat_cuda.launches += 1
    return out


#: process-wide count of kernel B launches (diagnostics: shows that a run
#: went through the kernel)
apply_flat_cuda.launches = 0


def apply_flat(
    xp: torch.Tensor,
    layout: PaddedLayout,
    flat: FlatTables,
    st: StencilTables,
) -> torch.Tensor:
    """y = A x: plain version for a CPU tensor, kernel B for a CUDA one."""
    if xp.device.type == "cpu":
        return apply_flat_plain(xp, layout, flat)
    if xp.device.type == "cuda":
        return apply_flat_cuda(xp, layout, st)
    raise ValueError(f"no implementation of apply_flat for device {xp.device}")


def apply_stencil_plain(
    xp: torch.Tensor, layout: PaddedLayout, st: StencilTables, ring: int = 0
) -> torch.Tensor:
    """y = A x on the whole padded state with the stencil tables, as the
    flat-layout kernels compute it at each point (``csrc/stencil_tiled.cuh``:
    the x band, then the merged shift-0 y/z tap, the other y taps and the
    other z taps, in that order); exactly 0 outside the interior grown by
    ``ring`` (:meth:`PaddedLayout.box`; a value-halo layout's launch box).
    A bf16 state is computed in float32 and rounded once."""
    dtype = xp.dtype
    xp, *tabs = widen(xp, *st)
    st = StencilTables(*tabs)
    p = layout.p
    Lx, Ly, Lz = layout.padded_shape
    F = Ly * Lz
    x2 = xp.reshape(Lx, F)
    tx = torch.zeros_like(x2)
    for k in range(2 * p + 1):
        # row g reads row g + k - p; rolls wrap only onto padding outputs
        tx = tx + st.cvx[k][:, None] * torch.roll(x2, p - k, 0)
    yz = (st.cvy[p] + st.cvz[p]) * x2
    for k in range(2 * p + 1):
        if k != p:
            yz = yz + st.cvy[k] * torch.roll(x2, (p - k) * Lz, 1)
    for k in range(2 * p + 1):
        if k != p:
            yz = yz + st.cvz[k] * torch.roll(x2, p - k, 1)
    y = tx * st.fx + yz * st.sx[:, None]
    x0, nx, h, ny, nz = layout.box(ring)
    inside = torch.zeros(layout.padded_shape, dtype=torch.bool, device=xp.device)
    inside[x0 : x0 + nx, h : h + ny, h : h + nz] = True
    return torch.where(inside.reshape(Lx, F), y, torch.zeros_like(y)).reshape(
        Lx, Ly, Lz).to(dtype)


def check_slab(layout: PaddedLayout) -> None:
    """Raise unless kernel E can run on this layout: every tap of an
    interior point must fall inside the padded state."""
    if layout.x0 < layout.p or layout.h < layout.p:
        raise ValueError(
            f"tile_x = {layout.tile_x} and the y/z padding {layout.h} must "
            f"be >= p = {layout.p} (the x-slab halo of the 3D-slab kernel)")


def apply_slab_plain(
    xp: torch.Tensor, layout: PaddedLayout, tables: SlabTables
) -> torch.Tensor:
    """y = A x on a padded [Lx, Ly, Lz] state of the 3D-slab layout,
    mirroring ``_kernel`` (tap form) tile by tile: the all-pad x-tiles are
    zeros; on each interior tile the x term sum_k CVX[k] U[x + k - p] times
    LYZ, then the y and z tap sums (cyclic rolls, which wrap only onto
    zero-coefficient padding outputs) times LXZ and LXY. A bf16 state and
    its tables are widened to float32 and the result rounded once, as
    kernel E stores it."""
    check_slab(layout)
    dtype = xp.dtype
    xp, LYZ, LXZ, LXY, CVX, CVY, CVZ = widen(xp, *tables)
    p = layout.p
    Tx = layout.tile_x
    Lx, Ly, Lz = layout.padded_shape
    K = 2 * p + 1
    out = torch.zeros_like(xp)
    for t in range(1, Lx // Tx - 1):
        rows = slice(t * Tx, (t + 1) * Tx)
        U = xp[t * Tx - p : t * Tx + Tx + p]
        acc = CVX[0, rows] * U[0:Tx]
        for k in range(1, K):
            acc = acc + CVX[k, rows] * U[k : k + Tx]
        o = acc * LYZ
        Uc = U[p : p + Tx]
        acc = CVY[p] * Uc
        for k in range(K):
            if k != p:
                acc = acc + CVY[k] * torch.roll(Uc, (p - k) % Ly, 1)
        o = o + acc * LXZ[rows]
        acc = CVZ[p] * Uc
        for k in range(K):
            if k != p:
                acc = acc + CVZ[k] * torch.roll(Uc, (p - k) % Lz, 2)
        out[rows] = o + acc * LXY[rows]
    return out.to(dtype)


def tma_launch_geometry(x: torch.Tensor, layout: PaddedLayout, fields: int,
                        extra: int, ring: int = tiling.RING, box_ring: int = 0):
    """``tiling.tma_geometry`` of ``layout`` (its box grown by ``box_ring``)
    for ``x``'s type on ``x``'s card (the H100's SM count for a tensor that
    is not on a card)."""
    sms = tiling.sm_count(x.device.index) if x.is_cuda else tiling.H100_SMS
    return tiling.tma_geometry(layout, x.element_size(), sms, fields, extra, ring,
                               box_ring)


def slab_launch_args(xp, out, layout: PaddedLayout, tables) -> tuple:
    """The arguments of the C launcher ``wave_apply_slab_tiled`` (kernel E)
    up to the stream: x, y, the six tables, the layout, then the tiling of
    ``tiling.tma_geometry`` on this card."""
    grid, ty, tz, cx, smem = tma_launch_geometry(xp, layout, 1, 0)
    Lx, Ly, Lz = layout.padded_shape
    Nx, Ny, Nz = layout.shape
    return (xp, out, *tables, layout.p, Lx, Ly, Lz, layout.x0, Nx, layout.h, Ny,
            Nz, ty, tz, cx, *grid, smem)


def apply_slab_cuda(
    xp: torch.Tensor,
    layout: PaddedLayout,
    tables: SlabTables,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = A x with the CUDA kernel E (one launch): every padded point
    written, 0 outside the interior, whatever ``out`` held. ``out``
    (optional) must not alias ``xp``."""
    check_slab(layout)
    shape = layout.padded_shape
    Lx, Ly, Lz = shape
    K = 2 * layout.p + 1
    if out is None:
        out = torch.empty_like(xp)
    t = SlabTables(*tables)
    _cuda.check_operands(
        xp.device, xp.dtype, x=(xp, shape), y=(out, shape),
        LYZ=(t.LYZ, (1, Ly, Lz)), LXZ=(t.LXZ, (Lx, 1, Lz)),
        LXY=(t.LXY, (Lx, Ly, 1)), CVX=(t.CVX, (K, Lx, 1, 1)),
        CVY=(t.CVY, (K, 1, Ly, 1)), CVZ=(t.CVZ, (K, 1, 1, Lz)),
    )
    if out.data_ptr() == xp.data_ptr():
        raise ValueError("out must not alias the input")
    _cuda.launch("wave_apply_slab_tiled", xp.dtype, xp.device,
                 *slab_launch_args(xp, out, layout, t))
    apply_slab_cuda.launches += 1
    return out


#: process-wide count of kernel E launches (diagnostics: shows that a run
#: went through the kernel)
apply_slab_cuda.launches = 0


def apply_slab(
    xp: torch.Tensor, layout: PaddedLayout, tables: SlabTables
) -> torch.Tensor:
    """y = A x on the 3D-slab layout: plain version for a CPU tensor,
    kernel E for a CUDA one."""
    if xp.device.type == "cpu":
        return apply_slab_plain(xp, layout, tables)
    if xp.device.type == "cuda":
        return apply_slab_cuda(xp, layout, tables)
    raise ValueError(f"no implementation of apply_slab for device {xp.device}")


def rk_stage_plain(
    u0: torch.Tensor,
    ku: torch.Tensor,
    v0: torch.Tensor,
    kv: torch.Tensor,
    ua: torch.Tensor,
    va: torch.Tensor,
    ca: float,
    cb: float,
    g: float,
    layout: PaddedLayout,
    c0: float,
    flat: FlatTables,
    w1: torch.Tensor,
    w2: torch.Tensor,
    src_x: int,
    abc_x: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One stage of the fused-stage RK4 path, mirroring ``_kernel_rk_stage``:
    un = u0 + ca ku, vn = v0 + ca kv, kv' = A un (the tile-by-tile apply of
    ``_kernel_flat``, which the stage kernel repeats on un) plus the source
    row c0^2 g W1 and the absorbing row -c0 W2 vn, ua' = ua + cb vn,
    va' = va + cb kv'. ``w1``/``w2`` are the [1, F] facet planes. Returns
    (vn, kv', ua', va'). A bf16 stage runs in float32 and rounds where
    kernel D stores: un (its stage-input plane) and the four outputs; ua'
    and va' add vn and kv' as stored, the values the next stage reads (the
    absorbing row takes vn before its rounding)."""
    Lx = layout.padded_shape[0]
    dtype = u0.dtype
    u0, ku, v0, kv, ua, va, w1, w2 = widen(u0, ku, v0, kv, ua, va, w1, w2)
    sc = lambda x: torch.tensor(x, dtype=u0.dtype, device=u0.device)  # noqa: E731
    ca_, cb_ = sc(ca), sc(cb)
    vn = v0 + ca_ * kv
    kvp = apply_flat_plain(stored(u0 + ca_ * ku, dtype), layout, flat)
    k2, vn2 = kvp.view(Lx, -1), vn.view(Lx, -1)
    k2[src_x] += (sc(c0 * c0) * sc(g)) * w1[0]
    k2[abc_x] += sc(-c0) * w2[0] * vn2[abc_x]
    vn, kvp = stored(vn, dtype), stored(kvp, dtype)
    return tuple(x.to(dtype) for x in (vn, kvp, ua + cb_ * vn, va + cb_ * kvp))


def rk_stage_launch_args(u0, ku, v0, kv, ua, va, vn, kvp, uap, vap, ca, cb, g,
                         layout: PaddedLayout, c0, st: StencilTables, w1, w2,
                         src_x, abc_x) -> tuple:
    """The arguments of the C launcher ``wave_rk_stage_tiled`` (kernel D)
    up to the stream: the fields, the face planes and rows, the scalars,
    the stencil, then the tiling of ``tiling.tma_geometry`` (``fields=2,
    extra=2``) on this card."""
    grid, ty, tz, cx, smem = tma_launch_geometry(u0, layout, 2, 2)
    return (u0, ku, v0, kv, ua, va, vn, kvp, uap, vap, w1, w2, int(src_x),
            int(abc_x), float(ca), float(cb), float(g), float(c0),
            *stencil_args(layout, st), ty, tz, cx, *grid, smem)


def rk_stage_cuda(
    u0: torch.Tensor,
    ku: torch.Tensor,
    v0: torch.Tensor,
    kv: torch.Tensor,
    ua: torch.Tensor,
    va: torch.Tensor,
    ca: float,
    cb: float,
    g: float,
    layout: PaddedLayout,
    c0: float,
    st: StencilTables,
    w1: torch.Tensor,
    w2: torch.Tensor,
    src_x: int,
    abc_x: int,
    out: tuple[torch.Tensor, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One RK4 stage with the CUDA kernel D (one launch). ``out`` =
    (vn, kv', ua', va') is reused when given; every padded point of each is
    written, whatever it held. ua' and va' are point-wise updates and may be
    ``ua``/``va`` themselves; vn (read at the taps as the next stage's
    ``ku``) and kv' may alias nothing."""
    layout.check_flat()
    shape = layout.padded_shape
    F = shape[1] * shape[2]
    dev, dtype = u0.device, u0.dtype
    if out is None:
        out = tuple(torch.empty_like(u0) for _ in range(4))
    vn, kvp, uap, vap = out
    _cuda.check_operands(
        dev, dtype,
        u0=(u0, shape), ku=(ku, shape), v0=(v0, shape), kv=(kv, shape),
        ua=(ua, shape), va=(va, shape), vn=(vn, shape), kv_out=(kvp, shape),
        ua_out=(uap, shape), va_out=(vap, shape),
        w1=(w1, (1, F)), w2=(w2, (1, F)),
    )
    check_stencil(layout, st, dev, dtype)
    _cuda.check_no_alias((vn, kvp, uap, vap), (u0, ku, v0, kv))
    _cuda.check_no_alias((vn, kvp, uap), (va,))
    _cuda.check_no_alias((vn, kvp, vap), (ua,))
    _cuda.launch("wave_rk_stage_tiled", dtype, dev, *rk_stage_launch_args(
        u0, ku, v0, kv, ua, va, vn, kvp, uap, vap, ca, cb, g, layout, c0, st,
        w1, w2, src_x, abc_x))
    rk_stage_cuda.launches += 1
    return vn, kvp, uap, vap


#: process-wide count of kernel D launches (four per step; diagnostics:
#: shows that a run went through the kernel)
rk_stage_cuda.launches = 0


def rk_stage(
    u0, ku, v0, kv, ua, va, ca: float, cb: float, g: float,
    layout: PaddedLayout, c0: float, flat: FlatTables, st: StencilTables,
    w1: torch.Tensor, w2: torch.Tensor, src_x: int, abc_x: int, out=None,
):
    """One fused RK4 stage: plain version for CPU tensors, kernel D for CUDA
    ones (``out`` is the kernel's reusable buffers)."""
    if u0.device.type == "cpu":
        return rk_stage_plain(u0, ku, v0, kv, ua, va, ca, cb, g, layout, c0,
                              flat, w1, w2, src_x, abc_x)
    if u0.device.type == "cuda":
        return rk_stage_cuda(u0, ku, v0, kv, ua, va, ca, cb, g, layout, c0,
                             st, w1, w2, src_x, abc_x, out=out)
    raise ValueError(f"no implementation of rk_stage for device {u0.device}")
