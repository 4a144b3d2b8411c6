"""Explicit-dofmap operator matvec (kernel K) and its plain version.

Port of ``wave_fenics_tpu.ops.pallas_general``: one operator apply on an
explicit dofmap (imported or unstructured hex meshes),

    y = coeff S(E(x_e)),   x_e[c, n] = x[dofmap[c, n]],

with S the scatter-add over the dofmap and E the element operator of one of
four modes (the TPU kernel's, ``pallas_general.py:401-529``):

- ``mass``: detJw .* x_e at the collocated GLL points;
- ``stiffness``: sum_{d,d'} D_d^T (G_dd' .* D_d' x_e) with the six symmetric
  G entries per node, or G = g6[c] w_q for affine (parallelepiped) cells;
- ``mass_gauss``: B^T diag(detJw_q) B x_e at non-collocated points;
- ``stiffness_gauss``: the full-G stiffness at non-collocated points.

:class:`GeneralTables` holds what both implementations read on a device:
the dofmap, the colouring of the cells (``gather_scatter.colour_cells``:
no two cells of one colour share a dof), the 1D tables B and D, and the
geometry per node (or per cell and w for affine cells).
:func:`general_apply_plain` is plain torch: gather -> ``element_kernels``
-> the same coloured scatter (``scatter_coloured``).
:func:`general_apply_cuda` launches kernel K (``csrc/general_kernels.cu``:
y = 0, then one launch per colour that adds its cells' coeff E(x_e)
straight into y; no atomics, so two applies agree bit for bit; the
collocated stiffness on a column-per-thread kernel). :func:`general_apply`
dispatches on the tensor's device: CPU -> plain, CUDA -> kernel K.

A bf16 x (bf16 B, D and geometry; the dofmap int32) is computed in float32
in both: the colours add into a float32 accumulator of ndofs (the kernel's
workspace), rounded once into the bf16 y at the end.

The TPU kernel's window and chain tables (``ops/general_tables.py``), gather
overflow, scatter merge, spill path, coarsening and resident mode exist
because Mosaic has no scattered loads; Hopper gathers natively, so none of
them is ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..convert import acc_dtype, widen
from . import _cuda
from . import element_kernels as ek
from . import gather_scatter as gs

__all__ = [
    "MODES",
    "MAX_DEGREE",
    "GeneralTables",
    "launch_shape",
    "general_apply",
    "general_apply_plain",
    "PlainK",
    "general_apply_cuda",
    "launch_args",
    "workspace",
]

MODES = ("mass", "stiffness", "mass_gauss", "stiffness_gauss")
#: highest degree kernel K takes (nd = 343 nodes per cell); the JAX package
#: leaves p > 6 to XLA (``operators.py:405-411``)
MAX_DEGREE = 6
#: threads of a ``general_element_kernel`` block (kThreads), the most
#: threads of a ``general_stiffness_kernel`` block (kColumnThreads: one a
#: (j, k) column of a cell), and the shared memory a block may use (H100:
#: 227 KB)
THREADS = 128
COLUMN_THREADS = 256
SMEM_LIMIT = 232_448
#: the symmetric G entries in table order
SYM = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


@dataclass(frozen=True)
class GeneralTables:
    """The device tables of one operator mode.

    dofmap [nc, m^3] int32; cells [nc] int32 on the tables' device and
    colour_starts [ncolours + 1] int32 on the CPU (the colouring of
    ``gather_scatter.colour_cells``); ndofs; B, D [nq, m]; geo
    [ngeo, nc, npts] per point, or [ngeo, nc] with w [npts] for affine
    cells (ngeo = 1 for the masses, 6 for the stiffnesses; npts = m^3
    collocated, nq^3 otherwise)."""

    mode: str
    dofmap: torch.Tensor
    cells: torch.Tensor
    colour_starts: torch.Tensor
    ndofs: int
    B: torch.Tensor
    D: torch.Tensor
    geo: torch.Tensor
    w: torch.Tensor | None = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r}: one of {MODES}")
        if self.affine and self.mode.endswith("_gauss"):
            raise ValueError("affine geometry serves the collocated modes only")

    @property
    def affine(self) -> bool:
        return self.w is not None

    @property
    def ncolours(self) -> int:
        return self.colour_starts.numel() - 1

    @property
    def ncells(self) -> int:
        return self.dofmap.shape[0]

    @property
    def m(self) -> int:
        return self.B.shape[1]

    @property
    def nq(self) -> int:
        return self.B.shape[0]

    @property
    def npts(self) -> int:
        return self.nq**3

    def geometry(self) -> torch.Tensor:
        """The geometry per point, [ngeo, nc, npts] (affine: g6[c] w_q), in
        the arithmetic type (``convert.acc_dtype``: bf16 tables widened to
        float32 before the product, as kernel K forms it)."""
        (geo,) = widen(self.geo)
        return geo[..., None] * widen(self.w)[0] if self.affine else geo


def launch_shape(mode: str, m: int, nq: int, itemsize: int) -> tuple[int, int, int]:
    """(cells per block, shared-memory elements per cell, shared-memory
    bytes) of kernel K's element launches; raises a ValueError where p > 6
    or the cell's buffers do not fit the card's shared memory.

    The collocated stiffness (``general_stiffness_kernel<T, M>``): one
    thread per (j, k) column, COLUMN_THREADS // m^2 cells a block, x_e, w_1
    and w_2 of each cell and the table D in static shared memory. The other
    modes (``general_element_kernel``): THREADS // points cells a block,
    dynamic shared memory. ``itemsize`` is the arithmetic type's (the cell
    buffers': 4 for a bf16 state)."""
    if m - 1 > MAX_DEGREE:
        raise ValueError(f"kernel K takes p <= {MAX_DEGREE}, not p = {m - 1}")
    Q = max(m, nq)
    if mode == "stiffness":
        cpb, stride = max(1, COLUMN_THREADS // m**2), 3 * m**3
        return cpb, stride, (cpb * stride + m * m) * itemsize
    if mode == "mass":
        points, stride = m**3, 0
    else:  # x_e; the three gradients and two temporaries at max(m, nq)^3
        points, stride = Q**3, m**3 + 5 * Q**3
    cpb = max(1, THREADS // points)
    smem = 0 if mode == "mass" else (cpb * stride + 2 * nq * m) * itemsize
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel K's {mode} at p = {m - 1} with {nq} points per "
                         f"axis needs {smem} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    return cpb, stride, smem


def general_apply_plain(x: torch.Tensor, t: GeneralTables, coeff=1.0) -> torch.Tensor:
    """y = coeff S(E(x_e)) in plain torch: gather, the element kernel of
    ``t.mode``, the coloured scatter of kernel K in its order. A bf16 x and
    its tables are widened to float32, the colours added in float32 and y
    rounded once, as kernel K computes it."""
    m, nq, nc = t.m, t.nq, t.ncells
    dtype = x.dtype
    x, B, D = widen(x, t.B, t.D)
    if isinstance(coeff, torch.Tensor):
        coeff = coeff.to(x.dtype)
    xe = gs.gather_indexed(x, t.dofmap).reshape(nc, m, m, m)
    geo = t.geometry().reshape(-1, nc, nq, nq, nq)
    if t.mode == "mass":
        ye = coeff * ek.spectral_mass_element(xe, geo[0])
    elif t.mode == "mass_gauss":
        ye = coeff * ek.mass_element(xe, B, geo[0])
    else:
        G = torch.stack([torch.stack([geo[SYM.index(tuple(sorted((a, b))))]
                                      for b in range(3)], dim=-1)
                         for a in range(3)], dim=-2)  # [nc, q, q, q, 3, 3]
        ye = ek.stiffness_element_full(xe, B, D, G, coeff)
    y = gs.scatter_coloured(ye, t.dofmap, t.cells, t.colour_starts, t.ndofs)
    return y.to(dtype)


class PlainK:
    """A general model's operators with kernel K's plain twin on ``ops``'s
    tables: ``stiffness`` only (what a model's ``f1`` and ``force`` call).
    Set as a model's ``ops``, it runs that model's solve on the plain
    twin."""

    def __init__(self, ops):
        self.ops = ops

    def stiffness(self, u, c0):
        return general_apply_plain(u, self.ops.tables(self.ops.mode("stiffness"), u.device),
                                   -float(c0) ** 2)


def workspace(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Kernel K's accumulator for ``x``: ``out`` itself in float32 and
    float64, a float32 buffer of ``x``'s size for a bf16 ``x``."""
    if x.dtype == torch.bfloat16:
        return torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return out


def launch_args(x: torch.Tensor, out: torch.Tensor, t: GeneralTables, coeff=1.0,
                colour_starts: torch.Tensor | None = None) -> tuple:
    """The arguments of the C launcher ``wave_general_apply`` (kernel K) up
    to the stream: the vectors, the accumulator (:func:`workspace`), the
    dofmap, the colouring (``colour_starts`` in place of ``t``'s, where
    given), the tables, the mode and the launch shape of
    :func:`launch_shape`."""
    m, nq = t.m, t.nq
    cpb, stride, smem = launch_shape(t.mode, m, nq,
                                     torch.finfo(acc_dtype(x.dtype)).bits // 8)
    cs = t.colour_starts if colour_starts is None else colour_starts
    return (x, out, workspace(x, out), t.dofmap, t.cells, cs, cs.numel() - 1, t.B, t.D, t.geo, t.w,
            MODES.index(t.mode), int(t.affine), m, nq, t.ncells, t.ndofs, cpb,
            stride, smem, float(coeff))


def general_apply_cuda(
    x: torch.Tensor, t: GeneralTables, coeff=1.0, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = coeff S(E(x_e)) with kernel K (y set to 0, then one launch per
    colour, and for a bf16 x the rounding pass of its float32 workspace;
    one count). ``coeff`` is a number or a 0-d tensor; ``out`` (optional)
    must not alias ``x``."""
    m, nq, nc, nd = t.m, t.nq, t.ncells, t.m**3
    if out is None:
        out = torch.empty_like(x)
    args = launch_args(x, out, t, coeff)  # raises where p > 6
    ngeo = 1 if t.mode.startswith("mass") else 6
    geo_shape = (ngeo, nc) if t.affine else (ngeo, nc, t.npts)
    floats = dict(x=(x, (t.ndofs,)), y=(out, (t.ndofs,)), B=(t.B, (nq, m)),
                  D=(t.D, (nq, m)), geo=(t.geo, geo_shape))
    if t.affine:
        floats["w"] = (t.w, (t.npts,))
    _cuda.check_operands(x.device, x.dtype, **floats)
    _cuda.check_index_operands(x.device, dofmap=(t.dofmap, (nc, nd)),
                               cells=(t.cells, (nc,)))
    _cuda.check_index_operands(torch.device("cpu"),
                               colour_starts=(t.colour_starts, (t.ncolours + 1,)))
    _cuda.check_no_alias((out,), (x,))
    _cuda.launch("wave_general_apply", x.dtype, x.device, *args)
    general_apply_cuda.launches += 1
    return out


#: process-wide count of kernel K applies (diagnostics: shows that a run went
#: through the kernel)
general_apply_cuda.launches = 0


def general_apply(x: torch.Tensor, t: GeneralTables, coeff=1.0) -> torch.Tensor:
    """y = coeff S(E(x_e)): plain version for a CPU tensor, kernel K for a
    CUDA one."""
    if x.device.type == "cpu":
        return general_apply_plain(x, t, coeff)
    if x.device.type == "cuda":
        return general_apply_cuda(x, t, coeff)
    raise ValueError(f"no implementation of general_apply for device {x.device}")
