"""A mesh that puts shared nodes at a node key's .5 boundary, for the
tests of ``build_dofmap`` (``test_torch_node_keys.py``, and on a card
``test_torch_gpu.py``). NumPy and the port only.

A perturbed (3,2,2)-cell box with every cell's vertex list rotated
(seeded), and two vertices moved so that one shared node's copies, summed
in vertex order, straddle a key's .5 boundary, and another's through
``np.matmul`` do; for the facet weights (``facet_split_mesh``), a third
vertex moved so that a node of the x = 0 face's facets, through the
bilinear facet map, does.
"""

import itertools

import numpy as np

from wave_fenics_tpu_torch.core.basis import gll_points_weights
from wave_fenics_tpu_torch.core.dofmap import node_phi, node_sums
from wave_fenics_tpu_torch.core.mesh import box_mesh

TOL = 1e-9
EXT = np.array([1.0, 0.8, 0.8])
CELLS = (3, 2, 2)
BITS = np.array([[(v >> d) & 1 for d in range(3)] for v in range(8)])


def symmetries(proper_only: bool) -> list[list[int]]:
    """The symmetries of the reference cube (signed axis permutations; the
    24 rotations, or all 48 with the reflections) as vertex permutations:
    local vertex j of the new list is vertex perm[j] of the old."""
    index = {tuple(b): v for v, b in enumerate(BITS)}
    out = []
    for axes in itertools.permutations(range(3)):
        for signs in itertools.product((1, -1), repeat=3):
            M = np.zeros((3, 3), int)
            M[range(3), axes] = signs
            if proper_only and round(np.linalg.det(M)) != 1:
                continue
            out.append([index[tuple((M @ (2 * b - 1) + 1) // 2)] for b in BITS])
    return out


def vertex_order_sums(phi, cc):
    """The node coordinates summed in vertex order (the port's node keys
    before the sorted sum)."""
    x = phi[None, :, 0, None] * cc[:, None, 0, :]
    for v in range(1, 8):
        x = x + phi[None, :, v, None] * cc[:, None, v, :]
    return x


def matmul_sums(phi, cc):
    """The node coordinates as the JAX package takes them (core/dofmap.py:169)."""
    return np.matmul(phi, cc)


def keys(x, inv):
    return np.rint(x.reshape(-1, 3) * inv).astype(np.int64)


def geometric_nodes(points, cells, p):
    """[nc nd] ids of the geometric nodes: the coordinates rounded at 1e-6,
    far coarser than the ulps that separate two copies of a node and far
    finer than the node spacing."""
    x = node_sums(node_phi(p), points[cells]).reshape(-1, 3)
    _, ids = np.unique(np.rint(x * 1e6).astype(np.int64), axis=0, return_inverse=True)
    return ids.reshape(-1)


def straddle(points, cells, p, sums, skip):
    """Move one vertex (not in ``skip``) so that the copies of a shared node
    computed by ``sums`` round to two keys; returns (points, vertex)."""
    phi = node_phi(p, mirrored=False)
    inv = 1.0 / (max(np.abs(points).max(), 1.0) * TOL)
    geo = geometric_nodes(points, cells, p)
    x = sums(phi, points[cells]).reshape(-1, 3)
    nd = phi.shape[0]
    for g in range(geo.max() + 1):
        rows = np.flatnonzero(geo == g)
        if len(rows) < 2 or (x[rows] == x[rows[0]]).all():
            continue
        i = int(np.flatnonzero((x[rows] != x[rows[0]]).any(axis=0))[0])
        c, n = divmod(int(rows[0]), nd)
        v = int(np.argmax(phi[n]))
        vid = int(cells[c, v])
        if vid in skip:
            continue
        # put the node's first copy at the key's .5 boundary, then walk the
        # vertex ulp by ulp until the copies round apart
        half = (np.floor(x[rows[0], i] * inv) + 0.5) / inv
        moved = points.copy()
        moved[vid, i] += (half - x[rows[0], i]) / phi[n, v]
        for s in range(400):
            y = sums(phi, moved[cells[rows // nd]])[np.arange(len(rows)), rows % nd, i]
            if len(set(np.rint(y * inv).tolist())) > 1:
                return moved, vid
            moved[vid, i] += (-1) ** s * (s + 1) * np.spacing(moved[vid, i])
    raise AssertionError("no shared node could be put at a key boundary")


def split_mesh(p: int) -> tuple[np.ndarray, np.ndarray]:
    """(points, cells): the perturbed box with rotated cells and two shared
    nodes at a key's .5 boundary (one for each unordered sum)."""
    rng = np.random.default_rng(0)
    hm = box_mesh(CELLS, tuple(EXT)).to_hex_mesh()
    pts = hm.points.copy()
    inner = np.all((pts > 1e-12) & (pts < EXT - 1e-12), axis=1)
    pts[inner] += 0.02 * rng.standard_normal(pts[inner].shape)
    rot = symmetries(proper_only=True)
    cells = np.array([c[rot[rng.integers(len(rot))]] for c in hm.cells])
    pts, v1 = straddle(pts, cells, p, vertex_order_sums, skip=())
    pts, _ = straddle(pts, cells, p, matmul_sums, skip={v1})
    return pts, cells


def expected_ndofs(p):
    return int(np.prod([n * p + 1 for n in CELLS]))


def one_dof_per_node(dofmap, points, cells, p) -> bool:
    """Every geometric node has exactly one dof and every dof one node."""
    geo = geometric_nodes(points, cells, p)
    pairs = np.unique(np.stack([geo, dofmap.reshape(-1)]), axis=1)
    return pairs.shape[1] == geo.max() + 1 == dofmap.max() + 1


def x0_facets(points, cells) -> np.ndarray:
    """[nf, 4] the cells' facets on the face x = 0 (within 1e-6: a moved
    vertex may leave it by ulps), in basix quad vertex order ((0,0), (1,0),
    (0,1), (1,1) of the facet's (y, z) parameters)."""
    out = []
    for c in cells:
        on = [int(v) for v in c if abs(points[v, 0]) < 1e-6]
        if len(on) == 4:
            out.append(sorted(on, key=lambda v: (round(points[v, 2], 6),
                                                 round(points[v, 1], 6))))
    return np.array(out)


def bilinear_facet_nodes(points, facets, p):
    """[nf (p+1)^2, 3] the facets' GLL nodes through the bilinear facet map
    (the facet weights' own map; its first parameter slowest)."""
    nodes, _ = gll_points_weights(p + 1)
    U, V = np.meshgrid(nodes, nodes, indexing="ij")
    u, v = U.ravel()[None, :, None], V.ravel()[None, :, None]
    fc = points[facets]
    v0, v1, v2, v3 = (fc[:, i, None, :] for i in range(4))
    x = (1 - u) * (1 - v) * v0 + u * (1 - v) * v1 + (1 - u) * v * v2 + u * v * v3
    return x.reshape(-1, 3)


def facet_split_mesh(p: int):
    """(points, cells, facets): :func:`split_mesh` with the x = 0 face's
    facets, and the face's middle vertex moved along y so that a facet node
    lies at a key's .5 boundary, where its bilinear-map coordinate and its
    dof's sorted sum round to two keys."""
    pts, cells = split_mesh(p)
    facets = x0_facets(pts, cells)
    inv = 1.0 / (max(np.abs(pts).max(), 1.0) * TOL)
    mid = [v for v in np.unique(facets) if 1e-9 < pts[v, 1] < EXT[1] - 1e-9
           and 1e-9 < pts[v, 2] < EXT[2] - 1e-9][0]

    def split(moved):
        dof_keys = set(map(tuple, keys(node_sums(node_phi(p), moved[cells]), inv).tolist()))
        return any(tuple(k) not in dof_keys
                   for k in keys(bilinear_facet_nodes(moved, facets, p), inv).tolist())

    f = int(np.flatnonzero((facets == mid).any(axis=1))[0])
    j = list(facets[f]).index(mid)
    nodes, _ = gll_points_weights(p + 1)
    for n in range(1, (p + 1) ** 2):
        u, v = nodes[n // (p + 1)], nodes[n % (p + 1)]
        w = ((1 - u) * (1 - v), u * (1 - v), (1 - u) * v, u * v)[j]
        if w < 0.1:
            continue
        y = bilinear_facet_nodes(pts, facets[f:f + 1], p)[n, 1]
        moved = pts.copy()
        moved[mid, 1] += ((np.floor(y * inv) + 0.5) / inv - y) / w
        for s in range(100):
            if split(moved):
                return moved, cells, facets
            moved[mid, 1] += (-1) ** s * (s + 1) * np.spacing(moved[mid, 1])
    raise AssertionError("no facet node could be put at a key boundary")
