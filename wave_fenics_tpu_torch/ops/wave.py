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
  (``csrc/wave_kernels.cu::apply_flat_kernel``), which reads the banded
  x coefficients ``cvx`` directly instead of a band matrix
  (:func:`stencil_tables`).

:func:`apply_flat` dispatches on the tensor's device: CPU -> plain, CUDA ->
kernel (or raise). There is no fallback between them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..convert import numpy_dtype
from . import _cuda
from .stiffness import banded_1d_coeffs

__all__ = [
    "PaddedLayout",
    "FlatTables",
    "StencilTables",
    "axis_cv_tables",
    "build_tables_flat",
    "stencil_tables",
    "apply_flat",
    "apply_flat_plain",
    "apply_flat_cuda",
]


def _r8(n):
    return -(-n // 8) * 8


@dataclass(frozen=True)
class PaddedLayout:
    """Aligned padded storage for a dof grid [Nx, Ny, Nz].

    Interior at offset (tile_x, p, p); padded dims:
    x = (ceil(Nx/tile_x) + 2) * tile_x, y = r8(Ny + 2p), and z rounded
    to ``z_align``. The alignments are the TPU's DMA rules, kept so that
    padded states match the JAX package's element for element. The padding
    beyond the interior must stay zero; operators preserve this invariant.
    """

    shape: tuple[int, int, int]
    p: int
    tile_x: int = 16
    z_align: int = 128

    @property
    def h(self) -> int:
        """y/z padding depth: p (the distributed layouts' deeper halo is not
        ported)."""
        return self.p

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
    npdt = numpy_dtype(dtype)

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
    return (
        WXT.astype(npdt), CVY.astype(npdt), CVZ.astype(npdt),
        FX.astype(npdt), GZ.astype(npdt), GY.astype(npdt), SX.astype(npdt),
    )


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
    Lx, Ly, Lz = layout.padded_shape
    F = Ly * Lz
    npdt = numpy_dtype(dtype)
    cvx, cvy, cvz, pLx, pLy, pLz = axis_cv_tables(
        layout, A, lines, coeff, inv_m_lines
    )
    gz = np.tile(pLz, Ly).reshape(1, F)
    gy = np.repeat(pLy, Lz).reshape(1, F)
    return (
        cvx.astype(npdt),
        pLx.astype(npdt),
        np.outer(pLy, pLz).reshape(F).astype(npdt),
        (np.repeat(cvy, Lz, axis=1) * gz).astype(npdt),
        (np.tile(cvz, (1, Ly)) * gy).astype(npdt),
    )


class FlatTables(NamedTuple):
    """Tensors of :func:`build_tables_flat` (plain version)."""

    WXT: torch.Tensor
    CVY: torch.Tensor
    CVZ: torch.Tensor
    FX: torch.Tensor
    GZ: torch.Tensor
    GY: torch.Tensor
    SX: torch.Tensor


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
    then the y and z roll terms; the two all-pad tiles are zeros."""
    _check_no_tf32(xp)
    layout.check_flat()
    WXT, CVY, CVZ, FX, GZ, GY, SX = tables
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
    return out.reshape(Lx, Ly, Lz)


def stencil_args(layout: PaddedLayout, st: StencilTables) -> tuple:
    """The stencil arguments of the C launchers (csrc/stencil.cuh order)."""
    Lx, Ly, Lz = layout.padded_shape
    Nx, Ny, Nz = layout.shape
    return (*st, layout.p, Lx, Ly, Lz, layout.x0, Nx, layout.h, Ny, Nz)


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


def apply_flat_cuda(
    xp: torch.Tensor,
    layout: PaddedLayout,
    st: StencilTables,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = A x with the CUDA kernel B (one launch). ``out`` (optional) must
    not alias ``xp``."""
    layout.check_flat()
    shape = layout.padded_shape
    if out is None:
        out = torch.empty_like(xp)
    _cuda.check_operands(xp.device, xp.dtype, x=(xp, shape), y=(out, shape))
    check_stencil(layout, st, xp.device, xp.dtype)
    if out.data_ptr() == xp.data_ptr():
        raise ValueError("out must not alias the input")
    _cuda.launch("wave_apply_flat", xp.dtype, xp.device, xp, out,
                 *stencil_args(layout, st))
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
