"""Consistent Gauss-quadrature mass (CEED BP1) on the padded layout (kernel G).

Port of ``wave_fenics_tpu.ops.pallas_mass``. The BP1 operator (forms
demo/gpu_cg/bp1.ufl:20-21; kernel semantics common/cuda/mass_kernel.cu:4-46)
is the consistent mass with p+2 Gauss points per direction. On a uniform
axis-aligned box it is an exact Kronecker product of three assembled 1D
mass matrices, M = Mx (x) My (x) Mz, so one matvec is three banded 1D
contractions, x then y then z:

    t1 = sum_k cvx[k, g] x[g + k - p, y, z]
    t2 = sum_k cvy[k, y] t1[g, y + k - p, z]
    y  = sum_k cvz[k, z] t2[g, y, z + k - p]

on the padded layout [Lx, Ly, Lz] of ``ops.wave.PaddedLayout`` (z_align 16
here, as the JAX package's mass uses it). The banded coefficient vectors
cvx [K, Lx], cvy [K, Ly], cvz [K, Lz] (:func:`mass_tables`, the JAX
package's ``_padded_cv``) are zero outside the interior, so the padding of
y comes out exactly zero and CG's axpy and dot run on padded vectors.

Two implementations on the same tables: :func:`mass_apply_plain` (plain
torch, three 1D passes over the whole state) and :func:`mass_apply_cuda`
(``csrc/mass_tiled.cu::mass_tiled_kernel``: one launch on the 2.5D tiled
stencil with TMA plane loads, contracting z, then y, then x;
:func:`mass_apply_zyx_plain` is its plain twin in that order).
:func:`mass_apply` dispatches on the tensor's device: CPU -> plain, CUDA
-> kernel.

A bf16 state (bf16 tables, :func:`mass_tables` rounding them from float64
as the JAX package's bf16 tables hold them) runs all three contractions in
float32 and rounds y once, in the kernel and in both plain versions.
:func:`mass_operator` builds a layout and its tables on a device;
:func:`bp1_setup` adds the BP1 problem's Jacobi map for CG.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as nnf

from ..convert import as_table, tables_from_numpy, widen
from . import _cuda, tiling
from .separable import separable_mass_tables
from .stiffness import banded_1d_coeffs
from .wave import PaddedLayout, tma_launch_geometry

__all__ = [
    "MassTables",
    "mass_tables",
    "mass_layout",
    "mass_operator",
    "bp1_setup",
    "mass_apply",
    "mass_apply_plain",
    "mass_apply_zyx_plain",
    "mass_apply_cuda",
    "mass_launch_args",
    "mass_fused",
]

#: p above which the JAX package's fused mass kernel refuses (its 8-deep
#: halo window, ``pallas_mass.py:169-170``); the port keeps the same domain
MAX_DEGREE = 8
#: x-tile of ``mass_fused``'s layout (the JAX package's, ``pallas_mass.py:235``)
FUSED_TILE_X = 16


class MassTables(NamedTuple):
    """Banded coefficient vectors [K, L_d] of the three assembled 1D masses,
    embedded in the padded extents (zero outside the interior)."""

    cvx: torch.Tensor
    cvy: torch.Tensor
    cvz: torch.Tensor


def mass_layout(shape: tuple[int, int, int], p: int, tile_x: int) -> PaddedLayout:
    """The padded layout of the BP1 mass (z_align 16, as ``mass_fused`` and
    ``cg_bench`` of the JAX package build it); raises where p > 8."""
    if p > MAX_DEGREE:
        raise ValueError(f"the fused mass supports p <= {MAX_DEGREE}, not p = {p}")
    return PaddedLayout(tuple(shape), p, tile_x=tile_x, z_align=16)


def mass_tables(
    layout: PaddedLayout, M1: list[np.ndarray], dtype=np.float64
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cvx, cvy, cvz) as NumPy arrays of ``dtype`` (``convert.as_table``:
    bf16 as float64 values rounded to bf16): per axis, the banded
    coefficient vectors of the assembled 1D mass from the cell block
    ``M1[d]`` (``separable_mass_tables``) in float64, embedded in the padded
    extent."""
    p = layout.p
    K = 2 * p + 1
    out = []
    for d in range(3):
        body = banded_1d_coeffs(np.asarray(M1[d], np.float64), layout.shape[d], p)
        out.append(as_table(np.stack([layout.padded_line(body[k], d)
                                      for k in range(K)]), dtype))
    return tuple(out)


def mass_operator(
    grid: tuple[int, int, int], p: int, M1: list[np.ndarray], dtype: torch.dtype,
    device: torch.device, tile_x: int = FUSED_TILE_X,
) -> tuple[PaddedLayout, MassTables]:
    """(layout, tables on ``device``) of the mass with 1D cell blocks ``M1``
    on a dof grid of shape ``grid``."""
    layout = mass_layout(tuple(grid), p, tile_x)
    tables = MassTables(*tables_from_numpy(mass_tables(layout, M1, dtype),
                                           device, dtype))
    return layout, tables


def bp1_setup(mesh, p: int, dtype: torch.dtype, device: torch.device,
              precond: bool = False, q: int | None = None):
    """(layout, tables, precond) of the BP1 mass on a structured box mesh
    in the padded layout: tile 32 at p = 1, else 16, z_align 16 (the JAX
    bench's ``_bp1_setup``); ``q`` is the quadrature exactness degree
    (default 2p+3); ``precond`` is the Jacobi map r -> r / diag(M) or
    None."""
    grid = tuple(n * p + 1 for n in mesh.shape)
    M1 = separable_mass_tables(p, mesh.h, dtype, q=q)
    layout, tables = mass_operator(grid, p, M1, dtype, device,
                                   tile_x=32 if p == 1 else 16)
    if not precond:
        return layout, tables, None
    # Kronecker diagonal: product of the assembled 1D mass diagonals
    lines = []
    for d in range(3):
        n = mesh.shape[d]
        diag = np.zeros(n * p + 1)
        dA = np.diag(np.asarray(M1[d], np.float64))
        for c in range(n):
            diag[c * p : c * p + p + 1] += dA
        lines.append(layout.padded_line(1.0 / diag, d))
    (inv_diag,) = tables_from_numpy(
        (np.einsum("i,j,k->ijk", *lines),), device, dtype)
    return layout, tables, lambda r: inv_diag * r


def _band(x: torch.Tensor, cv: torch.Tensor, p: int, axis: int) -> torch.Tensor:
    """sum_k cv[k] x[. + k - p] along ``axis`` (zero outside the array),
    the shift-0 tap first, as the TPU kernel's roll loops order them."""
    L = x.shape[axis]
    pads = [0, 0] * 3
    pads[2 * (2 - axis)] = pads[2 * (2 - axis) + 1] = p
    xp = nnf.pad(x, pads)
    shape = [1, 1, 1]
    shape[axis] = L
    acc = cv[p].reshape(shape) * x
    for k in range(2 * p + 1):
        if k != p:
            acc = acc + cv[k].reshape(shape) * xp.narrow(axis, k, L)
    return acc


def mass_apply_plain(
    xp: torch.Tensor, layout: PaddedLayout, tables: MassTables
) -> torch.Tensor:
    """y = (Mx (x) My (x) Mz) x on a padded [Lx, Ly, Lz] state: three 1D
    banded passes, x, y, z (a bf16 state in float32, y rounded once)."""
    p = layout.p
    dtype = xp.dtype
    xp, cvx, cvy, cvz = widen(xp, *tables)
    t = _band(xp, cvx, p, 0)
    t = _band(t, cvy, p, 1)
    return _band(t, cvz, p, 2).to(dtype)


def mass_apply_zyx_plain(
    xp: torch.Tensor, layout: PaddedLayout, tables: MassTables
) -> torch.Tensor:
    """The same y as :func:`mass_apply_plain` with the contractions in
    kernel G's order, z, then y, then x (``csrc/mass_tiled.cu``), rounding
    where it rounds: a bf16 state in float32, y rounded once."""
    p = layout.p
    dtype = xp.dtype
    xp, cvx, cvy, cvz = widen(xp, *tables)
    t = _band(xp, cvz, p, 2)
    t = _band(t, cvy, p, 1)
    return _band(t, cvx, p, 0).to(dtype)


def mass_launch_args(xp: torch.Tensor, out: torch.Tensor, layout: PaddedLayout,
                     tables: MassTables) -> tuple:
    """The arguments of the C launcher ``wave_mass_tiled`` (kernel G) up to
    the stream: x, y, the tables, the layout, then the tiling of
    ``tiling.tma_geometry`` (``fields=1, extra=2``: one TMA box of x a
    plane, two z-contracted planes; in bf16 ``extra=4``, the planes held in
    float32) on this card and its shared memory with cvx of a chunk's rows
    added. Raises a ValueError naming the
    condition a layout the kernel cannot tile breaks."""
    p = layout.p
    if p > MAX_DEGREE:
        raise ValueError(f"kernel G takes p <= {MAX_DEGREE}, not p = {p}")
    itemsize = xp.element_size()
    grid, ty, tz, cx, smem = tma_launch_geometry(xp, layout, 1, 2 * max(1, 4 // itemsize))
    smem += (2 * p + 1) * cx * itemsize
    tiling.check_tma_launch(layout, itemsize, ty, tz, smem)
    Lx, Ly, Lz = layout.padded_shape
    Nx, Ny, Nz = layout.shape
    return (xp, out, *tables, p, Lx, Ly, Lz, layout.x0, Nx, layout.h, Ny, Nz,
            ty, tz, cx, *grid, smem)


def mass_apply_cuda(
    xp: torch.Tensor,
    layout: PaddedLayout,
    tables: MassTables,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = (Mx (x) My (x) Mz) x with the CUDA kernel G (one launch): every
    padded point written, 0 outside the interior, whatever ``out`` held.
    ``out`` (optional) must not alias ``xp``."""
    p = layout.p
    shape = layout.padded_shape
    Lx, Ly, Lz = shape
    K = 2 * p + 1
    if out is None:
        out = torch.empty_like(xp)
    _cuda.check_operands(
        xp.device, xp.dtype, x=(xp, shape), y=(out, shape),
        cvx=(tables.cvx, (K, Lx)), cvy=(tables.cvy, (K, Ly)),
        cvz=(tables.cvz, (K, Lz)),
    )
    _cuda.check_no_alias((out,), (xp,))
    _cuda.launch("wave_mass_tiled", xp.dtype, xp.device,
                 *mass_launch_args(xp, out, layout, tables))
    mass_apply_cuda.launches += 1
    return out


#: process-wide count of kernel G launches (diagnostics: shows that a run
#: went through the kernel)
mass_apply_cuda.launches = 0


def mass_apply(
    xp: torch.Tensor, layout: PaddedLayout, tables: MassTables
) -> torch.Tensor:
    """y = M x on the padded layout: plain version for a CPU tensor, kernel G
    for a CUDA one."""
    if xp.device.type == "cpu":
        return mass_apply_plain(xp, layout, tables)
    if xp.device.type == "cuda":
        return mass_apply_cuda(xp, layout, tables)
    raise ValueError(f"no implementation of mass_apply for device {xp.device}")


_FUSED_CACHE: dict = {}
_FUSED_CACHE_MAX = 16  # each entry pins device tables; evict the oldest


def mass_fused(x: torch.Tensor, M1: list[np.ndarray], p: int) -> torch.Tensor:
    """One BP1 mass apply on an unpadded grid: pad, apply, unpad.

    The layout and the tables on ``x``'s device are cached per (shape, p,
    dtype, device, table bytes), so eager per-iteration callers do not
    rebuild and copy them per matvec; the cache is bounded (least recently
    used out first), as the JAX package's."""
    key = (tuple(x.shape), p, x.dtype, x.device,
           tuple(np.asarray(m).tobytes() for m in M1))
    hit = _FUSED_CACHE.pop(key, None)
    if hit is None:
        hit = mass_operator(tuple(x.shape), p, M1, x.dtype, x.device)
    _FUSED_CACHE[key] = hit  # re-insert: dict order == recency
    while len(_FUSED_CACHE) > _FUSED_CACHE_MAX:
        _FUSED_CACHE.pop(next(iter(_FUSED_CACHE)))
    layout, tables = hit
    return layout.unpad(mass_apply(layout.pad(x), layout, tables))
