"""The benchmark's meshes, made from a configuration's numbers alone
(NumPy, float64, host).

A jittered box: the lattice of a box of ``cells`` cubic cells of edge
h = ``length`` / cells[0], with every interior vertex moved by
``jitter_rel`` h times a standard normal drawn from ``mesh_seed``
(``numpy.random.default_rng``, the vertices in C order of the lattice, x
slowest). Vertices on the boundary stay put, so the six faces stay flat.
The draw is the port's ``benchmarks/general_solve.py::perturbed_box``'s,
bit for bit, so that the same numbers make the same mesh there.

The connectivity is the lattice's: cell (cx, cy, cz) has the vertices
(cx + a, cy + b, cz + c), a, b, c in {0, 1}, in basix hexahedron order
(local vertex a + 2 b + 4 c), and the cells are listed in C order. Its
GLL node (a, b, c), a, b, c in 0..p, is the node (p cx + a, p cy + b,
p cz + c) of the node lattice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["vertex_lattice", "hex_cells", "x_facets", "node_lattice_index"]


def vertex_lattice(config: dict) -> np.ndarray:
    """The vertices [nx + 1, ny + 1, nz + 1, 3] of the configuration's
    mesh (``cells``, ``length``, ``jitter_rel``, ``mesh_seed``)."""
    cells = tuple(config["cells"])
    h = config["length"] / cells[0]
    ext = np.asarray(cells, np.float64) * h
    axes = [(ext[d] / n) * np.arange(n + 1) for d, n in enumerate(cells)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3).copy()
    rng = np.random.default_rng(config["mesh_seed"])
    inner = np.all((pts > 1e-12) & (pts < ext - 1e-12), axis=1)
    pts[inner] += config["jitter_rel"] * h * rng.standard_normal(pts[inner].shape)
    return pts.reshape(*(n + 1 for n in cells), 3)


def hex_cells(cells) -> np.ndarray:
    """The cells' vertex ids [nx ny nz, 8] into the flattened lattice."""
    nx, ny, nz = cells
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    off = np.array([[v & 1, (v >> 1) & 1, (v >> 2) & 1] for v in range(8)], np.int64)
    return (((i.reshape(-1, 1) + off[:, 0]) * (ny + 1) + j.reshape(-1, 1) + off[:, 1])
            * (nz + 1) + k.reshape(-1, 1) + off[:, 2])


def x_facets(cells, side: int) -> np.ndarray:
    """The quad facets [ny nz, 4] of the face x = 0 (``side`` 0) or x = L
    (``side`` 1), each a cell's face in basix quad order, cell by cell."""
    hexes = hex_cells(cells).reshape(cells[0], -1, 8)
    return hexes[0][:, [0, 2, 4, 6]] if side == 0 else hexes[-1][:, [1, 3, 5, 7]]


def node_lattice_index(cells, p: int) -> np.ndarray:
    """The flat index into the node lattice [nx p + 1, ny p + 1, nz p + 1]
    of each cell's GLL nodes, [nx ny nz, (p + 1)^3], the nodes x slowest."""
    nx, ny, nz = cells
    Ny, Nz = ny * p + 1, nz * p + 1
    m = np.arange(p + 1)
    ci, cj, ck = (a.reshape(-1, 1, 1, 1) for a in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
    idx = ((p * ci + m[:, None, None]) * Ny + p * cj + m[None, :, None]) * Nz \
        + p * ck + m[None, None, :]
    return idx.reshape(nx * ny * nz, -1)
