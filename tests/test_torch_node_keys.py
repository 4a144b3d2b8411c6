"""Node keys on meshes whose cells list their vertices in different orders.

``build_dofmap`` numbers the dofs by rounding every (cell, node) coordinate
to a key of ``scale * tol``. A node shared by two cells is computed once in
each; where the two cells list the shared face's vertices in different
orders (each cell's local order is a rotation of the reference cube's), a
sum in vertex order rounds differently, and the GLL rule's lower nodes are
not exactly 1 - x of its upper ones. Where the node lies at a key's .5
boundary its two copies then get two keys, and the node two dofs.

The meshes here are perturbed (3,2,2)-cell boxes with every cell's vertex
list rotated (seeded), and two vertices moved so that one shared node's
copies, summed in vertex order (the port's node keys before the sorted sum),
straddle a key's .5 boundary, and another's through ``np.matmul`` (the JAX
package's keys) do. The port's two routes, the tensor route
(``device="cpu"``: ``native.node_keys_plain``) and the NumPy route
(``device=None``), must give every geometric node exactly one dof and the
same dofmap; the JAX package's ``build_dofmap`` splits the second node, a
fault of the reference (its comparison is a strict xfail).
"""

import numpy as np
import pytest
import torch
from _torch_cases import max_rel
from _torch_node_mesh import (
    BITS,
    EXT,
    TOL,
    bilinear_facet_nodes,
    expected_ndofs,
    facet_split_mesh,
    keys,
    matmul_sums,
    one_dof_per_node,
    split_mesh,
    symmetries,
    vertex_order_sums,
)

from wave_fenics_tpu.core.dofmap import build_dofmap as jbuild_dofmap
from wave_fenics_tpu.core.mesh import HexMesh as JHexMesh
from wave_fenics_tpu_torch import native
from wave_fenics_tpu_torch.core.dofmap import build_dofmap, node_phi, node_sums
from wave_fenics_tpu_torch.core.mesh import HexMesh
from wave_fenics_tpu_torch.models.general_wave import facet_lumped_weights

PS = [2, 3, 4, 5]


@pytest.fixture(scope="module", params=PS)
def split(request):
    p = request.param
    return p, *split_mesh(p)


def test_mesh_puts_shared_nodes_at_a_key_boundary(split):
    """The premise: the cells take several orientations, and both unordered
    sums (vertex order; np.matmul) split a shared node on this mesh."""
    p, pts, cells = split
    orders = {tuple(np.argsort(c)) for c in cells}
    assert len(orders) > 1
    phi = node_phi(p, mirrored=False)
    inv = 1.0 / (max(np.abs(pts).max(), 1.0) * TOL)
    for sums in (vertex_order_sums, matmul_sums):
        ndofs = len(np.unique(keys(sums(phi, pts[cells]), inv), axis=0))
        assert ndofs > expected_ndofs(p)


@pytest.mark.parametrize("reorder", ["appearance", "morton", None])
def test_port_routes_one_dof_per_node(split, reorder):
    """The tensor route (node_keys_plain) and the NumPy route: one dof per
    geometric node, (3p+1)(2p+1)^2 of them, the same dofmap and cell order."""
    p, pts, cells = split
    mesh = HexMesh(points=pts, cells=cells)
    got = build_dofmap(mesh, p, reorder=reorder, device="cpu")
    ref = build_dofmap(mesh, p, reorder=reorder)
    assert got.ndofs == ref.ndofs == expected_ndofs(p)
    np.testing.assert_array_equal(got.dofmap, ref.dofmap)
    if reorder == "morton":
        np.testing.assert_array_equal(got.cell_order, ref.cell_order)
    order = ref.cell_order if reorder == "morton" else np.arange(len(cells))
    assert one_dof_per_node(ref.dofmap, pts, cells[order], p)
    # the tensor route's dof coordinates are their nodes' sorted sums
    assert max_rel(got.dof_coords, ref.dof_coords) <= 1e-15


@pytest.mark.xfail(strict=True, reason=(
    "a fault of the reference: the JAX package's build_dofmap takes the node "
    "coordinates by np.matmul on the GLL rule's own nodes (core/dofmap.py:166-177), "
    "so two cells that list a shared face's vertices in different orders can round "
    "the node's copies to two keys at a key's .5 boundary and give it two dofs"))
def test_jax_build_dofmap_matches_the_port(split):
    """JAX's ndofs and dofmap against the port's, on the same mesh."""
    p, pts, cells = split
    want = build_dofmap(HexMesh(points=pts, cells=cells), p, device="cpu")
    got = jbuild_dofmap(JHexMesh(points=pts, cells=cells), p)
    assert got.ndofs == want.ndofs
    np.testing.assert_array_equal(got.dofmap, want.dofmap)


def test_node_keys_plain_is_node_sums(split):
    """The tensor route's keys and coordinates are the NumPy route's sorted
    sums, bit for bit, and the keys their quantization."""
    p, pts, cells = split
    phi = node_phi(p)
    scale = max(np.abs(pts).max(), 1.0)
    k, coords = native.node_keys_plain(torch.as_tensor(pts[cells]), torch.as_tensor(phi),
                                       scale, TOL)
    ref = node_sums(phi, pts[cells]).reshape(-1, 3)
    np.testing.assert_array_equal(coords.numpy(), ref)
    np.testing.assert_array_equal(k.numpy(), keys(ref, 1.0 / (scale * TOL)))


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_cell_boundary_nodes_do_not_depend_on_the_vertex_order(p):
    """Under each of the 48 symmetries of the reference cube applied to a
    perturbed cell's vertex list, every node on the cell's boundary (the
    nodes a neighbour can share) gets bitwise the same coordinates from
    native.node_keys_plain. A sum in vertex order does not."""
    rng = np.random.default_rng(p)
    X = BITS * np.array([0.3, 0.25, 0.2]) + 0.02 * rng.standard_normal((8, 3)) + 0.1
    phi = torch.as_tensor(node_phi(p))
    n = np.arange(p + 1)
    I, J, K = np.meshgrid(n, n, n, indexing="ij")
    on_boundary = ((I % p == 0) | (J % p == 0) | (K % p == 0)).ravel()
    _, base = native.node_keys_plain(torch.as_tensor(X[None]), phi, 1.0, TOL)
    base = base.numpy()[on_boundary]
    differs_in_vertex_order = False
    for perm in symmetries(proper_only=False):
        _, x = native.node_keys_plain(torch.as_tensor(X[perm][None]), phi, 1.0, TOL)
        x = x.numpy()
        # the same geometric node in the permuted cell: nearest coordinates
        match = np.argmin(np.abs(x[None, :, :] - base[:, None, :]).sum(-1), axis=1)
        np.testing.assert_array_equal(x[match], base)
        seq = vertex_order_sums(node_phi(p, mirrored=False), X[perm][None]).reshape(-1, 3)
        ref = vertex_order_sums(node_phi(p, mirrored=False), X[None]).reshape(-1, 3)
        differs_in_vertex_order |= not np.array_equal(seq[match], ref[on_boundary])
    assert differs_in_vertex_order or p == 1


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("p", [2, 4])
def test_facet_nodes_at_a_key_boundary_match_their_dofs(p, device):
    """A tagged facet node at a key's .5 boundary, where the bilinear facet
    map's coordinate and the node's sorted sum round to two keys (the
    premise), still matches its dof on both routes: the facet weights key
    their nodes from the sorted sums. The weights then sit on the face's
    dofs only and sum to its area (to 1e-8: a moved vertex leaves the plane
    x = 0 by ulps)."""
    pts, cells, facets = facet_split_mesh(p)
    inv = 1.0 / (max(np.abs(pts).max(), 1.0) * TOL)
    dof_keys = {tuple(k) for k in keys(node_sums(node_phi(p), pts[cells]), inv).tolist()}
    assert any(tuple(k) not in dof_keys
               for k in keys(bilinear_facet_nodes(pts, facets, p), inv).tolist())
    mesh = HexMesh(points=pts, cells=cells)
    dofs = build_dofmap(mesh, p, device=device)
    W = facet_lumped_weights(mesh, dofs, facets, p, device=device)
    W = W.numpy() if isinstance(W, torch.Tensor) else W
    on_face = np.abs(dofs.dof_coords[:, 0]) < 1e-6
    assert (W[~on_face] == 0).all() and (W[on_face] > 0).all()
    assert abs(W.sum() - EXT[1] * EXT[2]) <= 1e-8
