"""Structured hexahedral box meshes (host-side NumPy).

A copy of the structured-box part of ``wave_fenics_tpu.core.mesh``
(``BOX_FACETS``, ``FacetTags``, ``StructuredBoxMesh``, ``box_mesh``).
General imported hex meshes (``HexMesh``) are not ported yet.

Replaces the DOLFINx mesh layer consumed by the reference:
- ``mesh::create_box`` (demo/gpu_operator/main.cpp:60-72, etc.)
- cell-size query ``mesh::h`` (demo/cpu_planar3d/main.cpp:52-58)

The solver's hot path never touches mesh topology: for structured boxes,
dof gather/scatter is pure reshape/overlap-add (ops.gather_scatter) and
geometry factors are closed-form.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["BOX_FACETS", "FacetTags", "StructuredBoxMesh", "box_mesh"]

# Facet id convention for structured boxes: (axis, side) pairs.
# 0: x=lo, 1: x=hi, 2: y=lo, 3: y=hi, 4: z=lo, 5: z=hi
BOX_FACETS = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]


@dataclass(frozen=True)
class FacetTags:
    """Boundary tags: maps tag id -> tuple of box facet ids.

    Analogue of DOLFINx ``MeshTags`` over exterior facets
    (demo/cpu_planar3d/main.cpp:44-45). For structured boxes a tag selects
    whole box faces.
    """

    tags: dict[int, tuple[int, ...]] = field(default_factory=dict)

    def facets_of(self, tag: int) -> tuple[int, ...]:
        return self.tags.get(tag, ())


@dataclass(frozen=True)
class StructuredBoxMesh:
    """Axis-aligned box of uniform hex cells.

    shape:  number of cells per axis (nx, ny, nz)
    extent: physical lengths (Lx, Ly, Lz)
    origin: lower corner
    facet_tags: boundary tags over the 6 box faces
    """

    shape: tuple[int, int, int]
    extent: tuple[float, float, float]
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    facet_tags: FacetTags = field(default_factory=FacetTags)

    @property
    def ncells(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    @property
    def h(self) -> tuple[float, float, float]:
        """Cell edge lengths (hx, hy, hz)."""
        return tuple(L / n for L, n in zip(self.extent, self.shape))

    def hmin(self) -> float:
        """Smallest cell diameter (max inter-vertex distance), matching
        DOLFINx ``mesh::h`` used for the CFL timestep
        (demo/cpu_planar3d/main.cpp:52-58). Uniform cells -> all equal."""
        return float(np.sqrt(sum(h * h for h in self.h)))


def box_mesh(
    shape: tuple[int, int, int],
    extent: tuple[float, float, float],
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
    facet_tags: FacetTags | None = None,
) -> StructuredBoxMesh:
    """Convenience constructor mirroring ``mesh::create_box``."""
    return StructuredBoxMesh(
        shape=tuple(shape),
        extent=tuple(extent),
        origin=tuple(origin),
        facet_tags=facet_tags or FacetTags(),
    )
