"""Separable stiffness as a banded stencil on the unpadded grid (kernel F).

Port of ``wave_fenics_tpu.ops.pallas_stiffness``. The table functions
(``build_stencil_coeffs``, ``_cvec``, ``banded_1d_coeffs`` and the
coefficient expansion of ``_fused_call``) are copied so that the port
builds bit-identical tables without importing JAX.

On a uniform box the assembled 1D operator of a cell block A[m, m] is a
variable-coefficient stencil: (S u)[l] = sum_{k=-p..p} C[l mod p, k] u[l+k]
with

    r in 1..p-1:  C[r, j - r] = A[r, j]            (single covering cell)
    r == 0:       C[0, j]    += A[0, j]            (right cell)
                  C[0, j - p] += A[p, j]           (left cell)

and the separable stiffness on the dof grid [Nx, Ny, Nz] is

    y = (Sx x) (Ly (x) Lz) + (Sy x) (Lx (x) Lz) + (Sz x) (Lx (x) Ly)

with the lumped weight lines L_d and coeff = -c0^2 folded into C. A tap
outside [0, N) reads zero, which makes every phantom-cell term vanish
except the self-term at the two faces of each axis; the coefficient
vectors subtract those two corrections at index 0 and at N - 1. No 1/m
(kernel B, ``ops/wave.py``, computes the same stencil with 1/m folded in,
on the padded layout).

Two implementations of ``y = coeff K x`` on the same tables
(:func:`stiffness_grid_tables`): :func:`stiffness_grid_plain` (plain
torch, the TPU kernel's per-axis shifted multiply-adds on a zero-padded
copy) and :func:`stiffness_grid_cuda` (``csrc/stiffness_tiled.cu::
stiffness_tiled_kernel``, one launch on the tiling of
``tiling.grid_geometry``; the same sums in the same order).
:func:`stiffness_grid` dispatches on the tensor's device: CPU -> plain,
CUDA -> kernel. Both take a bf16 grid and tables (float32 sums, y rounded
once).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as nnf

from ..convert import as_table, widen
from . import _cuda, tiling

__all__ = [
    "banded_1d_coeffs",
    "build_stencil_coeffs",
    "GridStiffnessTables",
    "stiffness_grid_tables",
    "stiffness_grid",
    "stiffness_grid_plain",
    "stiffness_grid_cuda",
    "stiffness_launch_args",
    "MAX_DEGREE",
]

#: the highest degree kernel F takes (every degree StructuredOperators takes)
MAX_DEGREE = 10


def build_stencil_coeffs(A: np.ndarray, p: int) -> np.ndarray:
    """C[p, 2p+1] variable-coefficient stencil from the cell block A[m, m]."""
    C = np.zeros((p, 2 * p + 1), dtype=A.dtype)
    for j in range(p + 1):
        C[0, j + p] += A[0, j]       # right covering cell, k = j
        C[0, j] += A[p, j]           # left covering cell,  k = j - p
    for r in range(1, p):
        for j in range(p + 1):
            C[r, j - r + p] += A[r, j]
    return C


def _cvec(C: np.ndarray, k: int, n: int, p: int) -> np.ndarray:
    """Coefficient vector c[l] = C[l mod p, k] of length n."""
    pat = C[:, k]
    reps = -(-n // p)
    return np.tile(pat, reps)[:n]


def banded_1d_coeffs(Ad: np.ndarray, n: int, p: int, scale=1.0) -> np.ndarray:
    """Banded coefficient vectors [2p+1, n] of the assembled 1D operator
    ``scale * assemble(Ad)`` on an n-point axis, with the phantom-cell
    self-term corrections at the two domain faces (the periodic tiling of
    ``_cvec`` assumes a covering cell on both sides of every node; the
    first/last node have only one)."""
    Ad = np.asarray(Ad)
    K = 2 * p + 1
    C = build_stencil_coeffs(np.asarray(scale) * Ad, p)
    body = np.stack([_cvec(C, k, n, p) for k in range(K)])
    body[p, 0] -= scale * Ad[p, p]
    body[p, n - 1] -= scale * Ad[0, 0]
    return body


class GridStiffnessTables(NamedTuple):
    """Tables of kernel F and its plain version: banded coefficient vectors
    cvx [K, Nx], cvy [K, Ny], cvz [K, Nz] (coeff and the face corrections
    folded in) and the dimensionless lumped lines lx [Nx], ly [Ny], lz [Nz]."""

    cvx: torch.Tensor
    cvy: torch.Tensor
    cvz: torch.Tensor
    lx: torch.Tensor
    ly: torch.Tensor
    lz: torch.Tensor


def stiffness_grid_tables(
    A: list[np.ndarray],
    lines: list[np.ndarray],
    shape: tuple[int, int, int],
    p: int,
    coeff: float,
    dtype,
) -> tuple[np.ndarray, ...]:
    """(cvx, cvy, cvz, lx, ly, lz) as NumPy arrays of ``dtype``: the
    coefficient vectors of ``_fused_call``'s ``expand`` (the TPU stencil
    tables in ``dtype``, face corrections at index 0 and at the real N - 1)
    on the unpadded axes, and the lines. ``A``/``lines`` as
    separable_stiffness_tables/grid_lines make them; ``coeff`` = -c0^2. For
    bf16, float64 values (``convert.as_table``) that the tensor conversion
    rounds once."""
    K = 2 * p + 1
    cvs = []
    for Ad, n in zip(A, shape):
        C = as_table(build_stencil_coeffs(np.asarray(coeff) * Ad, p), dtype)
        cv = np.stack([_cvec(C, k, n, p) for k in range(K)])
        cv[p, 0] -= float(coeff) * Ad[p, p]      # left face: phantom left cell
        cv[p, n - 1] -= float(coeff) * Ad[0, 0]  # right face: phantom right cell
        cvs.append(cv)
    return (*cvs, *(as_table(ln, dtype) for ln in lines))


def stiffness_grid_plain(
    x: torch.Tensor, tables: GridStiffnessTables, p: int
) -> torch.Tensor:
    """y = coeff K x on the grid [Nx, Ny, Nz], as the TPU kernel computes it:
    per axis, sum_k cv[k] * (x shifted by k - p, zero outside the grid),
    then the line scalings, in the order x, y, z. A bf16 grid and its
    tables are widened to float32 and the result rounded once, as kernel F
    stores it."""
    dtype = x.dtype
    x, cvx, cvy, cvz, lx, ly, lz = widen(x, *tables)
    Nx, Ny, Nz = x.shape
    K = 2 * p + 1
    xp = nnf.pad(x, (p, p, p, p, p, p))

    def axis_sum(cv, window):
        acc = cv[0] * window(0)
        for k in range(1, K):
            acc = acc + cv[k] * window(k)
        return acc

    tx = axis_sum(cvx[:, :, None, None],
                  lambda k: xp[k:k + Nx, p:p + Ny, p:p + Nz])
    out = tx * (ly[:, None] * lz[None, :])
    ty = axis_sum(cvy[:, None, :, None],
                  lambda k: xp[p:p + Nx, k:k + Ny, p:p + Nz])
    out = out + ty * (lx[:, None] * lz[None, :])[:, None, :]
    tz = axis_sum(cvz[:, None, None, :],
                  lambda k: xp[p:p + Nx, p:p + Ny, k:k + Nz])
    return (out + tz * (lx[:, None] * ly[None, :])[:, :, None]).to(dtype)


def stiffness_launch_args(x: torch.Tensor, out: torch.Tensor,
                          tables: GridStiffnessTables, p: int) -> tuple:
    """The arguments of the C launcher ``wave_stiffness_tiled`` (kernel F)
    up to the stream: x, y, the six tables, p and the grid, then the tiling
    of ``tiling.grid_geometry`` on this card. Raises a ValueError naming
    the condition a degree or grid the kernel cannot take breaks."""
    if not 1 <= p <= MAX_DEGREE:
        raise ValueError(f"kernel F takes 1 <= p <= {MAX_DEGREE}, not p = {p}")
    Nx, Ny, Nz = x.shape
    sms = tiling.sm_count(x.device.index) if x.is_cuda else tiling.H100_SMS
    grid, ty, tz, cx, smem = tiling.grid_geometry((Nx, Ny, Nz), p, x.element_size(),
                                                  sms)
    if smem > tiling.SMEM_LIMIT:
        raise ValueError(f"kernel F needs {smem} bytes of shared memory a block, "
                         f"more than the {tiling.SMEM_LIMIT} an H100 block may use")
    return (x, out, *tables, p, Nx, Ny, Nz, ty, tz, cx, *grid, smem)


def stiffness_grid_cuda(
    x: torch.Tensor,
    tables: GridStiffnessTables,
    p: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = coeff K x with the CUDA kernel F (one launch): every grid point
    written, whatever ``out`` held. ``out`` (optional) must not alias
    ``x``."""
    shape = tuple(x.shape)
    if len(shape) != 3:
        raise ValueError(f"x must be a 3D dof grid, not shape {shape}")
    Nx, Ny, Nz = shape
    K = 2 * p + 1
    if out is None:
        out = torch.empty_like(x)
    _cuda.check_operands(
        x.device, x.dtype, x=(x, shape), y=(out, shape),
        cvx=(tables.cvx, (K, Nx)), cvy=(tables.cvy, (K, Ny)),
        cvz=(tables.cvz, (K, Nz)), lx=(tables.lx, (Nx,)),
        ly=(tables.ly, (Ny,)), lz=(tables.lz, (Nz,)),
    )
    _cuda.check_no_alias((out,), (x,))
    _cuda.launch("wave_stiffness_tiled", x.dtype, x.device,
                 *stiffness_launch_args(x, out, tables, p))
    stiffness_grid_cuda.launches += 1
    return out


#: process-wide count of kernel F launches (diagnostics: shows that a run
#: went through the kernel)
stiffness_grid_cuda.launches = 0


def stiffness_grid(
    x: torch.Tensor, tables: GridStiffnessTables, p: int
) -> torch.Tensor:
    """y = coeff K x: plain version for a CPU tensor, kernel F for a CUDA one."""
    if x.device.type == "cpu":
        return stiffness_grid_plain(x, tables, p)
    if x.device.type == "cuda":
        return stiffness_grid_cuda(x, tables, p)
    raise ValueError(f"no implementation of stiffness_grid for device {x.device}")
