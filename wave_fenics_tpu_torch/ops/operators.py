"""Matrix-free operators on a structured GLL dof grid.

Port of ``wave_fenics_tpu.ops.operators.StructuredOperators`` as far as the
planar3d slice needs it: ``grid_shape``, ``ndofs``, ``lumped_mass`` and
``stiffness`` (with c0 as a runtime parameter, the reference's skernel
semantics, common/operators.hpp:114-133).

Dispatch follows the tensor's device, as the JAX package's follows the
backend: a CPU tensor takes the plain separable formulation
(ops.separable); on a CUDA tensor the JAX package's counterpart is the
fused grid stiffness kernel (``ops/pallas_stiffness.py``), which is not
ported yet, so the call raises instead of running the plain version on
the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..convert import numpy_dtype, torch_dtype
from ..core.basis import lumped_weight_line, tabulate_1d
from ..core.mesh import StructuredBoxMesh
from .separable import grid_lines, separable_stiffness_tables, stiffness_separable

__all__ = ["StructuredOperators"]


@dataclass(frozen=True)
class StructuredOperators:
    """Matrix-free operators on a structured GLL dof grid.

    Built once per (mesh, p, dtype); the tables are tiny host NumPy arrays
    moved to the input's device at each call.
    """

    mesh: StructuredBoxMesh
    p: int
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if not tabulate_1d(self.p).collocated:
            raise ValueError("structured operators assume GLL collocation")
        A, _ = separable_stiffness_tables(self.p, self.mesh.h, self.dtype)
        object.__setattr__(self, "_sepA", A)
        object.__setattr__(
            self, "_seplines", grid_lines(self.mesh.shape, self.p, self.dtype)
        )

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(n * self.p + 1 for n in self.mesh.shape)

    @property
    def ndofs(self) -> int:
        gx, gy, gz = self.grid_shape
        return gx * gy * gz

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

    def stiffness(self, x: torch.Tensor, c0: float = 1.0) -> torch.Tensor:
        """y = -c0^2 * K x (sign convention of the reference skernel,
        common/operators.hpp:114-133)."""
        if x.device.type != "cpu":
            raise NotImplementedError(
                "StructuredOperators.stiffness on a CUDA tensor needs the "
                "fused grid stiffness kernel (ops/pallas_stiffness.py, "
                "kernel F in ROADMAP.md Queue 2), which is not ported yet"
            )
        dt = torch_dtype(self.dtype)
        A = [torch.as_tensor(a, device=x.device) for a in self._sepA]
        lines = [torch.as_tensor(ln, device=x.device) for ln in self._seplines]
        coeff = -torch.tensor(c0, dtype=dt) ** 2
        return stiffness_separable(x, A, lines, self.p, coeff)
