"""Hexahedral meshes (host-side NumPy): structured boxes and general hex meshes.

A copy of ``wave_fenics_tpu.core.mesh`` (``BOX_FACETS``, ``FacetTags``,
``StructuredBoxMesh``, ``box_mesh``, ``HexMesh``). A general mesh comes
from an XDMF file (``core/io.py``), from ``to_hex_mesh`` or as NumPy arrays
(``convert.general_mesh_from_numpy``).

Replaces the DOLFINx mesh layer consumed by the reference:
- ``mesh::create_box`` (demo/gpu_operator/main.cpp:60-72, etc.)
- cell-size query ``mesh::h`` (demo/cpu_planar3d/main.cpp:52-58)

The structured solver's hot path never touches mesh topology: for boxes,
dof gather/scatter is pure reshape/overlap-add (ops.gather_scatter) and
geometry factors are closed-form. ``HexMesh`` carries imported or
unstructured hex meshes as explicit vertices and cells, for the
explicit-dofmap path (``core.dofmap``, ``ops.general``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["BOX_FACETS", "HEX_FACES", "FacetTags", "StructuredBoxMesh", "HexMesh",
           "box_mesh"]

# Basix/DOLFINx hexahedron vertex order: the local vertex v has reference
# coordinates (v&1, (v>>1)&1, (v>>2)&1).
_VERTEX_COORDS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    dtype=np.float64,
)

# Facet id convention for structured boxes: (axis, side) pairs.
# 0: x=lo, 1: x=hi, 2: y=lo, 3: y=hi, 4: z=lo, 5: z=hi
BOX_FACETS = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]

#: the six quad faces of a hex, each in basix quad vertex order
HEX_FACES = [(0, 1, 2, 3), (0, 1, 4, 5), (0, 2, 4, 6), (1, 3, 5, 7),
             (2, 3, 6, 7), (4, 5, 6, 7)]


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

    def vertices_grid(self) -> np.ndarray:
        """Vertex coordinates as a grid [nx+1, ny+1, nz+1, 3]."""
        axes = [o + h * np.arange(n + 1)
                for o, h, n in zip(self.origin, self.h, self.shape)]
        return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)

    def cell_midpoints(self) -> np.ndarray:
        """Cell centres [ncells, 3], cells in C order over (cx, cy, cz) (x
        slowest, as ``to_hex_mesh`` lists them)."""
        axes = [o + h * (np.arange(n) + 0.5)
                for o, h, n in zip(self.origin, self.h, self.shape)]
        return np.stack([a.ravel() for a in np.meshgrid(*axes, indexing="ij")], axis=-1)

    def to_hex_mesh(self) -> "HexMesh":
        """Explicit vertex/cell representation (the general-geometry path and
        its oracles): vertices in C order of the vertex grid, cells in C
        order over (cx, cy, cz), each cell's vertices in basix order."""
        nx, ny, nz = self.shape
        i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                              indexing="ij")
        off = _VERTEX_COORDS.astype(np.int64)
        vid = ((i.reshape(-1, 1) + off[:, 0]) * (ny + 1)
               + j.reshape(-1, 1) + off[:, 1]) * (nz + 1) + k.reshape(-1, 1) + off[:, 2]
        return HexMesh(points=self.vertices_grid().reshape(-1, 3), cells=vid)


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


@dataclass(frozen=True)
class HexMesh:
    """General (possibly unstructured) trilinear hex mesh.

    points: [n_points, 3] vertex coordinates
    cells:  [n_cells, 8] vertex ids in basix hexahedron order
    facets: optional [n_tagged_facets, 4] vertex ids of tagged exterior facets
    facet_tag_values: optional [n_tagged_facets] integer tags
    """

    points: np.ndarray
    cells: np.ndarray
    facets: np.ndarray | None = None
    facet_tag_values: np.ndarray | None = None

    @property
    def ncells(self) -> int:
        return self.cells.shape[0]

    def cell_coords(self) -> np.ndarray:
        """Per-cell vertex coordinates, [n_cells, 8, 3]."""
        return self.points[self.cells]

    def hmin(self) -> float:
        """Smallest cell diameter (max pairwise vertex distance per cell)."""
        cc = self.cell_coords()
        d = np.linalg.norm(cc[:, :, None, :] - cc[:, None, :, :], axis=-1)
        return float(d.max(axis=(1, 2)).min())
