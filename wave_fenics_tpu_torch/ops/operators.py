"""Matrix-free operators: on a structured GLL dof grid, and on an explicit
dofmap.

Port of ``wave_fenics_tpu.ops.operators``: ``StructuredOperators`` (grid-level
equivalents of the reference's MassOperator, SpectralMassOperator and
StiffnessOperator, common/cuda/mass.hpp:17-107,
common/cuda/spectral_mass.hpp:23-100, common/operators.hpp:43-201, with c0
as a runtime parameter) and ``GeneralOperators`` (the same operators over
an explicit dofmap, for imported or unstructured hex meshes).

Dispatch follows the tensor's device, as the JAX package's follows the
backend. A CPU tensor takes the plain formulations (``ops.separable``); a
CUDA tensor takes the hand-written kernels where the JAX package takes a
Pallas kernel on the TPU: kernel F (``ops.stiffness``) for ``stiffness``
with a uniform coefficient, kernel G (``ops.mass``) for ``mass_gauss``.
Any other device raises. The diagonal masses, the gather/scatter roundtrip
and the per-cell stiffness are plain torch on every device, as the JAX
package computes them outside any Pallas kernel.

``GeneralOperators`` dispatches the same way: a CUDA tensor takes kernel K
(``ops.general``) for ``mass`` and ``stiffness`` in the mode the JAX
package's TPU dispatch picks (collocated: ``mass``/``stiffness``; Gauss:
``mass_gauss``/``stiffness_gauss``), and raises where K does not apply
(p > 6, or a Gauss rule whose cell buffers exceed the shared memory); a CPU
tensor takes K's plain version on the same tables. ``*_indexed`` and
``spectral_mass_roundtrip`` are plain torch on every device: the oracles.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..convert import (
    acc_dtype,
    as_table,
    table_dtype,
    tables_from_numpy,
    torch_dtype,
    widen,
)
from ..core import geometry
from ..core.basis import lumped_weight_line, tabulate_1d
from ..core.dofmap import GeneralDofMap
from ..core.mesh import HexMesh, StructuredBoxMesh
from . import element_kernels as ek
from . import gather_scatter as gs
from .general import SYM, GeneralTables, general_apply
from .mass import mass_fused
from .separable import (
    grid_lines,
    mass_separable,
    separable_mass_tables,
    separable_stiffness_tables,
    stiffness_separable,
)
from .stiffness import GridStiffnessTables, stiffness_grid, stiffness_grid_tables

__all__ = ["StructuredOperators", "GeneralOperators"]


@dataclass(frozen=True)
class StructuredOperators:
    """Matrix-free operators on a structured GLL dof grid.

    Built once per (mesh, p, dtype); the tables are host NumPy arrays, moved
    to a device once and kept there per (table, device, coefficient).
    ``coeff_cells`` (optional, shape [ncells]) is a per-cell stiffness
    coefficient; with it, ``stiffness`` takes the per-cell path.
    """

    mesh: StructuredBoxMesh
    p: int
    dtype: torch.dtype = torch.float32
    coeff_cells: object = None

    def __post_init__(self):
        tab = tabulate_1d(self.p)
        if not tab.collocated:
            raise ValueError("structured operators assume GLL collocation")
        m = self.p + 1
        npdt = table_dtype(self.dtype)
        Gdiag, detJw = geometry.structured_geometric_factors(self.mesh, self.p)
        Gd = Gdiag.reshape(1, m, m, m, 3).astype(npdt)
        if self.coeff_cells is not None:
            cc = np.asarray(self.coeff_cells, dtype=npdt)
            Gd = Gd * cc[:, None, None, None, None]
        A, _ = separable_stiffness_tables(self.p, self.mesh.h, self.dtype)
        setattr_ = object.__setattr__
        setattr_(self, "_D", tab.D.astype(npdt))
        setattr_(self, "_detJw", detJw.reshape(1, m, m, m).astype(npdt))
        setattr_(self, "_Gdiag", Gd)
        setattr_(self, "_sepA", A)
        setattr_(self, "_seplines", grid_lines(self.mesh.shape, self.p, self.dtype))
        setattr_(self, "_on_device", {})

    def _tensors(self, key, device: torch.device, make) -> tuple[torch.Tensor, ...]:
        """The tables ``make()`` (NumPy) as tensors of the operator dtype on
        ``device``, built and copied once per (key, device)."""
        k = (key, device)
        if k not in self._on_device:
            self._on_device[k] = tables_from_numpy(make(), device, self.dtype)
        return self._on_device[k]

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(n * self.p + 1 for n in self.mesh.shape)

    @property
    def ndofs(self) -> int:
        gx, gy, gz = self.grid_shape
        return gx * gy * gz

    # -- data movement ---------------------------------------------------
    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gs.gather_grid(x, self.p)

    def scatter(self, ye: torch.Tensor) -> torch.Tensor:
        return gs.scatter_grid(ye, self.p, self.mesh.shape)

    # -- operators --------------------------------------------------------
    @cached_property
    def lumped_mass(self) -> np.ndarray:
        """m = M @ 1 as a grid: the diagonal of M under GLL collocation
        (LinearGLL.hpp:105-110), the separable overlap-add of 1D GLL weight
        lines (NumPy)."""
        lines = [
            lumped_weight_line(self.mesh.shape[d], self.p, self.mesh.h[d])
            for d in range(3)
        ]
        return as_table(np.einsum("i,j,k->ijk", *lines), self.dtype)

    def mass(self, x: torch.Tensor) -> torch.Tensor:
        """Collocated mass matvec: the lumped diagonal times x."""
        (m,) = self._tensors("lumped_mass", x.device, lambda: (self.lumped_mass,))
        return m * x

    def spectral_mass(self, x: torch.Tensor) -> torch.Tensor:
        """y = M x for the GLL-collocated (spectral) mass. On a structured
        grid the assembled M is diagonal, so the apply is one multiply (the
        reference's gather -> detJw -> scatter route is
        :meth:`spectral_mass_roundtrip`)."""
        return self.mass(x)

    def spectral_mass_roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """y = M x via gather -> pointwise detJw -> scatter, the reference's
        data-movement shape (spectral_mass.hpp:84-89)."""
        (detJw,) = self._tensors("detJw", x.device, lambda: (self._detJw,))
        return self.scatter(ek.spectral_mass_element(self.gather(x), detJw))

    def mass_gauss(self, x: torch.Tensor, q: int | None = None) -> torch.Tensor:
        """Consistent (non-lumped) mass matvec with Gauss quadrature, the
        CEED BP1 operator (demo/gpu_cg/bp1.ufl:20-21; default p+2 points).

        CPU: the three sequential banded contractions of
        ``ops.separable.mass_separable``. CUDA: ``ops.mass.mass_fused``, one
        launch of kernel G on the padded layout (raises for p > 8, as the
        JAX package's fused kernel does). A bf16 x: float32 contractions on
        the bf16 tables, y rounded once, as kernel G computes it."""
        M1 = separable_mass_tables(self.p, self.mesh.h, self.dtype, q=q)
        if x.device.type == "cpu":
            acc = acc_dtype(x.dtype)
            return mass_separable(x.to(acc), [torch.as_tensor(m, dtype=acc) for m in M1],
                                  self.p).to(x.dtype)
        if x.device.type == "cuda":
            return mass_fused(x, M1, self.p)
        raise ValueError(f"no implementation of mass_gauss for device {x.device}")

    def stiffness(self, x: torch.Tensor, c0=1.0) -> torch.Tensor:
        """y = -c0^2 K x (sign convention of the reference skernel,
        common/operators.hpp:114-133).

        With ``coeff_cells`` set, the per-cell path. Otherwise CPU: the
        separable formulation (``ops.separable``); CUDA: kernel F
        (``ops.stiffness``), with -c0^2 folded into its tables (c0 a number
        or a 0-d tensor). A bf16 x: the separable formulation in float32 on
        the bf16 tables, rounded once, as kernel F computes it."""
        if self.coeff_cells is not None:
            return self.stiffness_percell(x, c0)
        if x.device.type == "cpu":
            acc = acc_dtype(self.dtype)
            A = [torch.as_tensor(a, dtype=acc) for a in self._sepA]
            lines = [torch.as_tensor(ln, dtype=acc) for ln in self._seplines]
            coeff = -torch.as_tensor(c0, dtype=acc) ** 2
            y = stiffness_separable(x.to(acc), A, lines, self.p, coeff)
            return y.to(x.dtype)
        if x.device.type == "cuda":
            coeff = -float(c0) ** 2
            tables = self._tensors(
                ("stiffness", coeff), x.device,
                lambda: stiffness_grid_tables(self._sepA, self._seplines,
                                              self.grid_shape, self.p, coeff,
                                              self.dtype))
            return stiffness_grid(x, GridStiffnessTables(*tables), self.p)
        raise ValueError(f"no implementation of stiffness for device {x.device}")

    def stiffness_percell(self, x: torch.Tensor, c0=1.0) -> torch.Tensor:
        """The generic per-cell path (gather -> element contraction ->
        scatter), plain torch on every device; the cross-implementation
        oracle, and the only path for a per-cell coefficient."""
        D, Gdiag = self._tensors("percell", x.device,
                                 lambda: (self._D, self._Gdiag))
        coeff = -torch.as_tensor(c0, dtype=torch_dtype(self.dtype)) ** 2
        ye = ek.stiffness_element_diag(self.gather(x), D, Gdiag, coeff)
        return self.scatter(ye)


def _affine_factors(G, detJw, w3: np.ndarray) -> dict | None:
    """{"g6": [6, nc], "dJ": [nc], "w": w3} where every cell is affine
    (a parallelepiped: G[c, q] = g6[c] w_q and detJw[c, q] = |det J[c]| w_q
    to 1e-12 of the largest), else None; NumPy arrays or tensors, as G."""
    if isinstance(G, torch.Tensor):
        stack, w3 = torch.stack, torch.as_tensor(w3, device=G.device)
    else:
        stack = np.stack
    nc = G.shape[0]
    Gs = stack([G[:, :, a, b] for a, b in SYM]).reshape(6, nc, -1)
    dJw = detJw.reshape(nc, -1)
    g6 = Gs[:, :, :1] / w3[0]
    dJ = dJw[:, :1] / w3[0]
    gs_scale = max(float(abs(Gs).max()), 1e-300)
    dj_scale = max(float(abs(detJw).max()), 1e-300)
    if (float(abs(Gs - g6 * w3).max()) <= 1e-12 * gs_scale
            and float(abs(dJw - dJ * w3).max()) <= 1e-12 * dj_scale):
        return {"g6": g6[..., 0], "dJ": dJ[:, 0], "w": w3}
    return None


@dataclass(frozen=True)
class GeneralOperators:
    """Matrix-free operators over an explicit dofmap (imported hex meshes).

    Supports non-collocated quadrature (``rule='gauss'``, the decomposed
    B^T D B pipeline of demo/gpu_operator) and full 3x3 geometric factors.
    Vectors are flat ``[ndofs]`` tensors. ``coeff_cells`` (optional, shape
    [ncells]) is a per-cell stiffness coefficient, folded into G at setup.

    ``device=None``: the tables are built on the host in NumPy (the oracle)
    and copied to a device once per (table, device). A device: G, |det J| w,
    the coefficient fold, the affine test and the lumped mass are computed
    there (``precompute_geometric_data(..., device=...)``: the hand-written
    kernel on a card), K's tables are made there from them, and the NumPy
    forms that host code reads (``lumped_mass``) are made on demand only. A
    dofmap built on the same device lends its device copy.

    bf16 (``dtype=torch.bfloat16``): B, D, G and |det J| w computed in
    float64 and rounded once (the JAX package's bf16 tables bit for bit);
    the lumped mass is M @ 1 of those rounded tables summed in float64 and
    rounded once; -c0^2 stays float32 (the JAX package rounds c0 to bf16
    first, 1500 -> 1504); the operators and oracles compute in float32 and
    round y once.
    """

    mesh: HexMesh
    dofs: GeneralDofMap
    dtype: torch.dtype = torch.float32
    q: int | None = None
    rule: str = "gll"
    coeff_cells: object = None
    device: torch.device | str | None = None

    def __post_init__(self):
        p = self.dofs.p
        tab = tabulate_1d(p, self.q, self.rule)
        G, detJw = geometry.precompute_geometric_data(self.mesh, p, self.q, self.rule,
                                                      device=self.device)
        if self.coeff_cells is not None:
            coeff = np.asarray(self.coeff_cells, dtype=np.float64)
            if isinstance(G, torch.Tensor):
                coeff = torch.as_tensor(coeff, device=G.device)
            G = G * coeff[:, None, None, None]
        nq, nc = tab.nq, self.mesh.ncells
        setattr_ = object.__setattr__
        setattr_(self, "_tab", tab)
        setattr_(self, "_B", as_table(tab.B, self.dtype))
        setattr_(self, "_D", as_table(tab.D, self.dtype))
        # affine (parallelepiped) cells, detected on the float64 factors
        affine = (_affine_factors(G, detJw, geometry.quadrature_weights_3d(tab))
                  if tab.collocated else None)
        setattr_(self, "_affine", affine)
        if isinstance(G, torch.Tensor):
            G, detJw = G.to(self.dtype), detJw.to(self.dtype)
        else:
            G, detJw = as_table(G, self.dtype), as_table(detJw, self.dtype)
        setattr_(self, "_detJw", detJw.reshape(nc, nq, nq, nq))
        setattr_(self, "_G", G.reshape(nc, nq, nq, nq, 3, 3))
        setattr_(self, "_dofmap", self.dofs.dofmap)
        setattr_(self, "_on_device", {})
        if self.device is not None:
            dev = G.device
            dm = self.dofs.device_dofmap
            if dm is not None and dm.device == dev:
                self._on_device[("dofmap", dev)] = (dm,)
            self._on_device[("lumped_mass", dev)] = (self._lumped_mass_tensor(dev),)

    def _tensors(self, key, device: torch.device, make, dtype=None) -> tuple[torch.Tensor, ...]:
        """The tables ``make()`` (NumPy, or tensors of the device route) as
        tensors of ``dtype`` (default: the operator's) on ``device``, built
        once per (key, device)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        k = (key, device)
        if k not in self._on_device:
            self._on_device[k] = tables_from_numpy(make(), device, dtype or self.dtype)
        return self._on_device[k]

    @property
    def ndofs(self) -> int:
        return self.dofs.ndofs

    @property
    def affine(self) -> bool:
        """Whether every cell is a parallelepiped (rank-1 geometry)."""
        return self._affine is not None

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        m = self.dofs.p + 1
        (dofmap,) = self._tensors("dofmap", x.device, lambda: (self._dofmap,),
                                  torch.int32)
        return gs.gather_indexed(x, dofmap).reshape(-1, m, m, m)

    def scatter(self, ye: torch.Tensor) -> torch.Tensor:
        """Element -> dof scatter-add (an indexed add; the oracles' scatter)."""
        (dofmap,) = self._tensors("dofmap", ye.device, lambda: (self._dofmap,),
                                  torch.int32)
        return gs.scatter_indexed(ye.reshape(self.mesh.ncells, -1), dofmap, self.ndofs)

    # -- kernel K's tables --------------------------------------------------
    def tables(self, mode: str, device: torch.device) -> GeneralTables:
        """Kernel K's tables of ``mode`` on ``device`` (built once each)."""
        (dofmap,) = self._tensors("dofmap", device, lambda: (self._dofmap,), torch.int32)
        (cells,) = self._tensors("colours", device, lambda: self.colouring[:1], torch.int32)
        B, D = self._tensors("BD", device, lambda: (self._B, self._D))
        return GeneralTables(mode, dofmap, cells, self._colour_starts, self.ndofs, B, D,
                             *self.geometry_tables(mode, device))

    def geometry_tables(self, mode: str, device: torch.device) -> tuple[torch.Tensor, ...]:
        """Kernel K's geometry of ``mode`` on ``device`` (built once each):
        (geo [ngeo, nc, npts],), or (geo [ngeo, nc], w [npts]) where every
        cell is affine."""
        af = self._affine if mode in ("mass", "stiffness") else None
        nc = self.mesh.ncells

        def make():
            if af is not None:
                geo = af["dJ"][None] if mode == "mass" else af["g6"]
                return geo, af["w"]
            if mode.startswith("mass"):
                return (self._detJw.reshape(1, nc, -1),)
            G = self._G.reshape(nc, -1, 3, 3)
            stack = torch.stack if isinstance(G, torch.Tensor) else np.stack
            return (stack([G[:, :, a, b] for a, b in SYM]),)

        return self._tensors(("geo", mode), device, make)

    @cached_property
    def colouring(self) -> tuple[np.ndarray, np.ndarray]:
        """(cells, colour_starts) of ``gather_scatter.colour_cells``: kernel
        K's colours, no two cells of one share a dof (NumPy, host, once)."""
        return gs.colour_cells(self._dofmap, self.dofs.p + 1)

    @cached_property
    def _colour_starts(self) -> torch.Tensor:
        return torch.as_tensor(self.colouring[1], dtype=torch.int32)

    def mode(self, op: str) -> str:
        """Kernel K's mode of ``op`` ("mass" or "stiffness") under this
        operator set's quadrature: ``op``, or ``op + "_gauss"`` off the GLL
        points."""
        return op if self._tab.collocated else f"{op}_gauss"

    def _apply(self, op: str, x: torch.Tensor, coeff) -> torch.Tensor:
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no implementation of {op} for device {x.device}")
        return general_apply(x, self.tables(self.mode(op), x.device), coeff)

    # -- operators --------------------------------------------------------
    def mass(self, x: torch.Tensor) -> torch.Tensor:
        """y = M x, the general sum-factorized B^T diag(detJw) B per element
        (mass_apply semantics, common/cuda/mass_kernel.cu:4-46): kernel K on
        a card, its plain version on the CPU; collocated quadrature makes B
        the identity (K's ``mass`` mode)."""
        return self._apply("mass", x, 1.0)

    def mass_indexed(self, x: torch.Tensor) -> torch.Tensor:
        """The oracle of :meth:`mass`: gather -> per-element B^T diag(detJw)
        B -> indexed scatter, plain torch, any rule."""
        B, detJw = widen(*self._tensors("mass_indexed", x.device,
                                        lambda: (self._B, self._detJw)))
        return self.scatter(ek.mass_element(self.gather(widen(x)[0]), B, detJw)).to(x.dtype)

    def spectral_mass(self, x: torch.Tensor) -> torch.Tensor:
        """y = M x for the collocated (diagonal) mass: one multiply by the
        assembled diagonal."""
        if not self._tab.collocated:
            raise ValueError("spectral_mass needs collocated (GLL) quadrature")
        return self.lumped_mass_on(x.device) * x

    def spectral_mass_roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """The reference-shaped gather -> detJw -> scatter path
        (spectral_mass.hpp:84-89); collocated quadrature only."""
        if not self._tab.collocated:
            raise ValueError("spectral_mass_roundtrip needs collocated (GLL) quadrature")
        (detJw,) = widen(*self._tensors("detJw", x.device, lambda: (self._detJw,)))
        ye = ek.spectral_mass_element(self.gather(widen(x)[0]), detJw)
        return self.scatter(ye).to(x.dtype)

    @cached_property
    def lumped_mass(self) -> np.ndarray:
        """m = M @ 1 (NumPy, of :func:`convert.table_dtype`: bf16 summed in
        float64 and rounded once; on the device route, copied from the
        device on first use)."""
        if self.device is not None:
            m = self.lumped_mass_on(self._G.device).cpu()
            return (m.double() if m.dtype == torch.bfloat16 else m).numpy()
        m1 = self.dofs.p + 1
        nc = self.mesh.ncells
        npdt = table_dtype(self.dtype)
        ones = np.ones((nc, m1, m1, m1), dtype=npdt)
        uq = np.einsum("qi,cijk->cqjk", self._B, ones)
        uq = np.einsum("qj,cijk->ciqk", self._B, uq)
        uq = np.einsum("qk,cijk->cijq", self._B, uq) * self._detJw
        ye = np.einsum("qi,cqjk->cijk", self._B, uq)
        ye = np.einsum("qj,ciqk->cijk", self._B, ye)
        ye = np.einsum("qk,cijq->cijk", self._B, ye)
        out = np.zeros((self.ndofs,), dtype=npdt)
        np.add.at(out, self._dofmap.ravel(), ye.reshape(nc, -1).ravel())
        return as_table(out, self.dtype)

    def lumped_mass_on(self, device) -> torch.Tensor:
        """m = M @ 1 as a tensor on ``device`` (on the device route, the
        one computed there)."""
        (m,) = self._tensors("lumped_mass", device, lambda: (self.lumped_mass,))
        return m

    def _lumped_mass_tensor(self, device: torch.device) -> torch.Tensor:
        """m = M @ 1 on ``device`` from the device route's detJw: the
        per-element B^T diag(detJw) B 1, added in the NumPy route's order
        (``scatter_ordered``), so two builds agree bit for bit (bf16: in
        float64, rounded once)."""
        m1 = self.dofs.p + 1
        nc = self.mesh.ncells
        wide = torch.float64 if self.dtype == torch.bfloat16 else self.dtype
        (B,) = tables_from_numpy((self._B,), device, wide)
        ones = torch.ones((nc, m1, m1, m1), dtype=wide, device=device)
        ye = ek.mass_element(ones, B, self._detJw.to(wide))
        (dofmap,) = self._tensors("dofmap", device, lambda: (self._dofmap,), torch.int32)
        return gs.scatter_ordered(ye, dofmap, self.ndofs).to(self.dtype)

    def _coeff(self, x: torch.Tensor, c0):
        """-c0^2: a float for kernel K, a 0-d tensor of the arithmetic type
        (float32 for bf16) for the plain versions."""
        if x.device.type == "cuda":
            return -float(c0) ** 2
        return -torch.as_tensor(c0, dtype=acc_dtype(self.dtype)) ** 2

    def stiffness(self, x: torch.Tensor, c0=1.0) -> torch.Tensor:
        """y = -c0^2 K x with the full G (skernel semantics,
        common/operators.hpp:112-133): kernel K on a card, its plain version
        on the CPU. ``c0`` is a number or a 0-d tensor."""
        return self._apply("stiffness", x, self._coeff(x, c0))

    def stiffness_indexed(self, x: torch.Tensor, c0=1.0) -> torch.Tensor:
        """The oracle of :meth:`stiffness`: gather -> per-element full-G
        contraction -> indexed scatter, plain torch on every device."""
        B, D, G = widen(*self._tensors("stiffness_indexed", x.device,
                                       lambda: (self._B, self._D, self._G)))
        coeff = -torch.as_tensor(c0, dtype=B.dtype, device=x.device) ** 2
        ye = ek.stiffness_element_full(self.gather(widen(x)[0]), B, D, G, coeff)
        return self.scatter(ye).to(x.dtype)
