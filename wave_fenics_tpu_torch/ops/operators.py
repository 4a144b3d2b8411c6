"""Matrix-free operators on a structured GLL dof grid.

Port of ``wave_fenics_tpu.ops.operators.StructuredOperators`` (grid-level
equivalents of the reference's MassOperator, SpectralMassOperator and
StiffnessOperator, common/cuda/mass.hpp:17-107,
common/cuda/spectral_mass.hpp:23-100, common/operators.hpp:43-201, with c0
as a runtime parameter).

Dispatch follows the tensor's device, as the JAX package's follows the
backend. A CPU tensor takes the plain formulations (``ops.separable``); a
CUDA tensor takes the hand-written kernels where the JAX package takes a
Pallas kernel on the TPU: kernel F (``ops.stiffness``) for ``stiffness``
with a uniform coefficient, kernel G (``ops.mass``) for ``mass_gauss``.
Any other device raises. The diagonal masses, the gather/scatter roundtrip
and the per-cell stiffness are plain torch on every device, as the JAX
package computes them outside any Pallas kernel.

The explicit-dofmap family (``GeneralOperators``, imported meshes) belongs
to the general-mesh slice and is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..convert import numpy_dtype, tables_from_numpy, torch_dtype
from ..core import geometry
from ..core.basis import lumped_weight_line, tabulate_1d
from ..core.mesh import StructuredBoxMesh
from . import element_kernels as ek
from . import gather_scatter as gs
from .mass import mass_fused
from .separable import (
    grid_lines,
    mass_separable,
    separable_mass_tables,
    separable_stiffness_tables,
    stiffness_separable,
)
from .stiffness import GridStiffnessTables, stiffness_grid, stiffness_grid_tables

__all__ = ["StructuredOperators"]


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
        npdt = numpy_dtype(self.dtype)
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
        return np.einsum("i,j,k->ijk", *lines).astype(numpy_dtype(self.dtype))

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
        JAX package's fused kernel does)."""
        M1 = separable_mass_tables(self.p, self.mesh.h, self.dtype, q=q)
        if x.device.type == "cpu":
            return mass_separable(x, [torch.as_tensor(m) for m in M1], self.p)
        if x.device.type == "cuda":
            return mass_fused(x, M1, self.p)
        raise ValueError(f"no implementation of mass_gauss for device {x.device}")

    def stiffness(self, x: torch.Tensor, c0=1.0) -> torch.Tensor:
        """y = -c0^2 K x (sign convention of the reference skernel,
        common/operators.hpp:114-133).

        With ``coeff_cells`` set, the per-cell path. Otherwise CPU: the
        separable formulation (``ops.separable``); CUDA: kernel F
        (``ops.stiffness``), with -c0^2 folded into its tables (c0 a number
        or a 0-d tensor)."""
        if self.coeff_cells is not None:
            return self.stiffness_percell(x, c0)
        if x.device.type == "cpu":
            A = [torch.as_tensor(a) for a in self._sepA]
            lines = [torch.as_tensor(ln) for ln in self._seplines]
            coeff = -torch.as_tensor(c0, dtype=torch_dtype(self.dtype)) ** 2
            return stiffness_separable(x, A, lines, self.p, coeff)
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
