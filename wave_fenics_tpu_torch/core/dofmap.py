"""Continuous-Galerkin dof numbering on hex meshes.

A copy of ``wave_fenics_tpu.core.dofmap``: ``StructuredDofGrid`` (the dof
grid of a structured box, ``[Nx, Ny, Nz]`` with ``Nd = n_cells_d * p + 1``;
its node lines place probes and label XDMF output) and the general part
(``GeneralDofMap``, ``build_dofmap``, ``morton_cell_order``). It replaces
the DOLFINx dofmap the reference leans on (``V->dofmap()->list()``,
common/operators.hpp:56): an explicit ``dofmap[nc, (p+1)^3]`` built by
geometric dedup of the element nodes. ``build_dofmap`` has two routes: the
NumPy ``np.unique`` route (``device=None``, the JAX package's own fallback
where its native library is absent, and the oracle), and the tensor route
on a device, the counterpart of the JAX package's native route
(``native.node_keys`` and ``native.dedup_dofs``: the hand-written kernels
on a card, their plain versions on the CPU), which gives the same numbering.

Element-local tensors use axes [c, i, j, k] with i -> x, j -> y, k -> z and
C-order flattening (z fastest), matching ``geometry.quadrature_points_3d``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from .basis import gll_points_weights
from .geometry import trilinear_tabulate
from .mesh import HexMesh, StructuredBoxMesh

__all__ = ["StructuredDofGrid", "GeneralDofMap", "build_dofmap", "morton_cell_order",
           "node_phi", "node_sums"]


@dataclass(frozen=True)
class StructuredDofGrid:
    """Degree-p GLL dof grid over a structured box mesh."""

    mesh: StructuredBoxMesh
    p: int

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(n * self.p + 1 for n in self.mesh.shape)

    @property
    def ndofs(self) -> int:
        gx, gy, gz = self.grid_shape
        return gx * gy * gz

    @property
    def ncells(self) -> int:
        return self.mesh.ncells

    def axis_coords(self, axis: int) -> np.ndarray:
        """Physical node coordinates along one axis, shape [n*p+1]."""
        n = self.mesh.shape[axis]
        h = self.mesh.h[axis]
        o = self.mesh.origin[axis]
        nodes, _ = gll_points_weights(self.p + 1)
        line = o + h * (np.arange(n)[:, None] + nodes[None, :])  # [n, p+1]
        return np.concatenate([line[:, :-1].ravel(), line[-1:, -1]])

    def dof_coords_grid(self) -> np.ndarray:
        """Node coordinates as [Nx, Ny, Nz, 3]."""
        X, Y, Z = np.meshgrid(*(self.axis_coords(d) for d in range(3)), indexing="ij")
        return np.stack([X, Y, Z], axis=-1)

    def dofmap(self) -> np.ndarray:
        """Explicit dofmap [ncells, (p+1)^3] (flat global ids, C-order grid,
        cells ordered x slowest)."""
        nx, ny, nz = self.mesh.shape
        _, gy, gz = self.grid_shape
        p = self.p
        m = p + 1
        ax = [np.arange(n)[:, None] * p + np.arange(m)[None, :] for n in (nx, ny, nz)]
        gi = ax[0][:, None, None, :, None, None]  # [nx,1,1,m,1,1]
        gj = ax[1][None, :, None, None, :, None]
        gk = ax[2][None, None, :, None, None, :]
        flat = (gi * gy + gj) * gz + gk  # [nx,ny,nz,m,m,m]
        return flat.reshape(nx * ny * nz, m * m * m).astype(np.int32)


@dataclass(frozen=True)
class GeneralDofMap:
    """Explicit dofmap of a general hex mesh (geometric dedup numbering)."""

    dofmap: np.ndarray  # [nc, (p+1)^3] int32
    ndofs: int
    dof_coords: np.ndarray  # [ndofs, 3]
    p: int
    #: cell permutation applied before numbering (reorder='morton'); apply
    #: the same order to any per-cell data (mesh.cells[cell_order])
    cell_order: np.ndarray | None = None
    #: built on a device (``build_dofmap(..., device=...)``): the dofmap
    #: there, and each dof's quantized coordinate key [ndofs, 3] int64 (the
    #: key of its first node; the facet weights match facet nodes against it)
    device_dofmap: torch.Tensor | None = None
    device_keys: torch.Tensor | None = None

    @property
    def ncells(self) -> int:
        return self.dofmap.shape[0]


def morton_cell_order(mesh: HexMesh, bits: int = 10) -> np.ndarray:
    """Cell permutation by the Morton (Z-order) code of the cell centroids:
    neighbouring cells, and so their shared dofs, come close together."""
    c = mesh.cell_coords().mean(axis=1)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-300)
    q = np.clip(((c - lo) / span * (2**bits - 1)).astype(np.uint64), 0, 2**bits - 1)

    def spread(v):
        out = np.zeros_like(v)
        for b in range(bits):
            out |= ((v >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b)
        return out

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def node_phi(p: int, mirrored: bool = True) -> np.ndarray:
    """The trilinear basis [(p+1)^3, 8] at the element's GLL nodes (x
    slowest). ``mirrored``: the nodes below 1/2 are 1 - x of those above, bit
    for bit (the GLL rule's own lower nodes can miss that by an ulp), so a
    node shared by two cells that run opposite ways along an axis gets the
    same weights on the same vertices in both."""
    nodes, _ = gll_points_weights(p + 1)
    if mirrored:
        nodes = np.where(nodes >= 0.5, nodes, 1.0 - nodes[::-1])
    X, Y, Z = np.meshgrid(nodes, nodes, nodes, indexing="ij")
    phi, _ = trilinear_tabulate(np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1))
    return phi


def node_sums(phi: np.ndarray, cell_coords: np.ndarray) -> np.ndarray:
    """x[c, n] = sum_v phi[n, v] X[c, v] [nc, nd, 3], the eight products of
    a component summed in ascending order of value: an order that does not
    depend on how a cell lists its vertices (``native.node_keys``'s, bit for
    bit). A sum in vertex order, or BLAS's, can round two cells' copies of a
    shared node apart, and so split it where it lies at a key's .5
    boundary."""
    nc, nd = cell_coords.shape[0], phi.shape[0]
    out = np.empty((nc, nd, 3))
    for c in range(0, nc, native.KEY_CHUNK):
        prod = np.sort(phi[None, :, :, None] * cell_coords[c : c + native.KEY_CHUNK, None],
                       axis=2)
        x = prod[:, :, 0].copy()
        for v in range(1, 8):
            x += prod[:, :, v]
        out[c : c + native.KEY_CHUNK] = x
    return out


def build_dofmap(
    mesh: HexMesh, p: int, tol: float = 1e-9, reorder: str | None = "appearance",
    device: torch.device | str | None = None,
) -> GeneralDofMap:
    """CG dof numbering by geometric dedup of the trilinear-mapped GLL nodes.

    Nodes on shared faces and edges coincide exactly under the trilinear map
    (a face restriction depends only on the face's vertices), so dedup of
    the coordinates rounded at relative tolerance ``tol`` is exact for
    non-degenerate meshes. Both routes take the keys from :func:`node_sums`
    on :func:`node_phi`'s mirrored nodes, so the copies of a shared node get
    one key however the cells list their vertices; the JAX package's keys
    (a BLAS matmul on the GLL rule's nodes) can split such a node in two
    where it lies at a key's .5 boundary, and otherwise agree.

    ``reorder='appearance'`` (default) keeps the cell order and numbers dofs
    by first appearance in the cell-major traversal, so consecutive cells
    touch a narrow id range; ``'morton'`` first reorders the cells along a
    Z-order curve (callers then apply ``cell_order`` to per-cell data);
    ``None`` numbers dofs by sorted geometric key.

    ``device=None`` takes the NumPy route, whose ``dof_coords`` are the JAX
    package's (each dof's last node through ``np.matmul``). A device takes
    the tensor route there (``native.node_keys``, ``native.dedup_dofs``; the
    Morton cell order stays on the host): the same ``dofmap`` and ``ndofs``,
    and ``dof_coords`` of each dof's first node from the sorted sum (the two
    may differ in the last bits). It also keeps the dofmap and the dof keys
    on the device (``device_dofmap``, ``device_keys``).
    """
    cell_order = None
    if reorder == "morton":
        cell_order = morton_cell_order(mesh)
        mesh = HexMesh(points=mesh.points, cells=mesh.cells[cell_order])
    m = p + 1
    scale = max(np.abs(mesh.points).max(), 1.0)
    if device is not None:
        return _build_dofmap_tensors(mesh, p, node_phi(p), scale, tol, reorder,
                                     cell_order, torch.device(device))
    cc = mesh.cell_coords()
    coords = np.matmul(node_phi(p, mirrored=False), cc)  # [nc, nd, 3]

    # quantize in place: fresh temporaries of this size page-fault at scale
    flat = node_sums(node_phi(p), cc).reshape(-1, 3)
    np.multiply(flat, 1.0 / (scale * tol), out=flat)
    np.rint(flat, out=flat)
    key = flat.astype(np.int64)

    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    ndofs = uniq.shape[0]
    if reorder in ("morton", "appearance"):
        # renumber by first appearance in the cell-major traversal
        _, first = np.unique(inv, return_index=True)
        order = np.argsort(first, kind="stable")  # old ids by appearance
        new_of_old = np.empty(ndofs, dtype=np.int64)
        new_of_old[order] = np.arange(ndofs)
        inv = new_of_old[inv]
    dofmap = inv.reshape(coords.shape[0], m * m * m).astype(np.int32)
    dof_coords = np.zeros((ndofs, 3))
    dof_coords[dofmap.ravel()] = coords.reshape(-1, 3)
    return GeneralDofMap(dofmap=dofmap, ndofs=ndofs, dof_coords=dof_coords, p=p,
                         cell_order=cell_order)


def _build_dofmap_tensors(mesh: HexMesh, p: int, phi: np.ndarray, scale: float,
                          tol: float, reorder: str | None, cell_order,
                          device: torch.device) -> GeneralDofMap:
    """The tensor route of :func:`build_dofmap` on ``device``: the keys of
    every (cell, node), ids by first appearance (``dedup_dofs``), then for
    ``reorder=None`` the rank of each dof's key in sorted order."""
    nc, nd = mesh.ncells, (p + 1) ** 3
    pts = torch.as_tensor(mesh.points, dtype=torch.float64, device=device)
    cells = torch.as_tensor(np.asarray(mesh.cells), dtype=torch.int64, device=device)
    cc = pts[cells].contiguous()  # [nc, 8, 3]
    phi_t = torch.as_tensor(phi, dtype=torch.float64, device=device)
    keys, coords = native.node_keys(cc, phi_t, scale, tol)
    ids, ndofs, first = native.dedup_dofs(keys, return_first=True)
    dof_keys, dof_coords = keys[first], coords[first]
    if reorder not in ("morton", "appearance"):
        # number by sorted key: the rank of each dof's key among the keys
        _, rank = torch.unique(dof_keys, dim=0, return_inverse=True)
        order = torch.empty_like(rank)
        order[rank] = torch.arange(ndofs, device=device)
        ids = rank[ids.long()].to(torch.int32)
        dof_keys, dof_coords = dof_keys[order], dof_coords[order]
    dofmap = ids.reshape(nc, nd)
    return GeneralDofMap(dofmap=dofmap.cpu().numpy(), ndofs=ndofs,
                         dof_coords=dof_coords.cpu().numpy(), p=p, cell_order=cell_order,
                         device_dofmap=dofmap, device_keys=dof_keys)
