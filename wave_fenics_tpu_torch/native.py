"""General-mesh set-up on a device: geometry factors, node keys, dof dedup
and the box's cell array.

Port of ``wave_fenics_tpu.native`` (``geometry_factors``, ``dedup_dofs``,
``box_cells``; the C++ host library ``native/wavecore.cpp``) and of the
node-key step of ``core/dofmap.py::build_dofmap``. Each function takes
tensors and dispatches on their device: a CUDA tensor goes to its
hand-written kernel (``csrc/setup_kernels.cu``: ``geometry_factors_kernel``,
``node_keys_kernel``, ``dedup_insert_kernel`` + ``dedup_lookup_kernel``), a
CPU tensor to its plain version, any other device raises. There is no
fallback: a build or launch failure raises.

- :func:`geometry_factors`: (G [nc, nq, 3, 3], detJw [nc, nq]) of trilinear
  hexes by wavecore's adjugate formula, with ``clamp_table``'s snap of G;
  J on the coordinates relative to each cell's vertex 0 (the same J, without
  the cancellation that costs wavecore's and NumPy's |X| / h ulps).
- :func:`node_keys`: the quantized coordinate key of every (cell, node).
- :func:`dedup_dofs`: dof ids of the keys, numbered by first appearance in
  the flat cell-major order, as wavecore's serial hash numbers them.
- :func:`box_cells`: plain torch on every device (the box's cell array is
  O(nc) index arithmetic; ``StructuredBoxMesh.to_hex_mesh`` gives the same).

wavecore's ``assign_chains`` and ``scatter_merge_batch`` build the TPU
kernel's chain tables and have no counterpart: kernel K gathers natively.
"""

from __future__ import annotations

import torch

from .ops import _cuda

__all__ = [
    "THREADS",
    "geometry_factors",
    "geometry_factors_plain",
    "geometry_factors_cuda",
    "geometry_launch_shape",
    "clamp_plain",
    "node_keys",
    "node_keys_plain",
    "node_keys_cuda",
    "dedup_dofs",
    "dedup_dofs_plain",
    "dedup_dofs_cuda",
    "dedup_table_size",
    "box_cells",
]

F64 = torch.float64
#: threads of a set-up kernel block (kThreads of csrc/setup_kernels.cu)
THREADS = 256
#: most quadrature points a geometry block's tile takes
GEOMETRY_TILE = 128
#: the snap of ``core/basis.py::clamp_table`` (np.isclose's rtol, atol)
CLAMP_RTOL, CLAMP_ATOL = 1e-5, 1e-8


def _dispatch(name: str, t: torch.Tensor, plain, cuda, *args, **kw):
    if t.device.type == "cpu":
        return plain(*args, **kw)
    if t.device.type == "cuda":
        return cuda(*args, **kw)
    raise ValueError(f"no implementation of {name} for device {t.device}")


# -- geometry factors ---------------------------------------------------------
def clamp_plain(G: torch.Tensor) -> torch.Tensor:
    """``clamp_table`` on a tensor: entries within 1e-8 + 1e-5 |v| of v =
    -1, 0, 1 (in that order) become v."""
    out = G.clone()
    for v in (-1.0, 0.0, 1.0):
        out[(out - v).abs() <= CLAMP_ATOL + CLAMP_RTOL * abs(v)] = v
    return out


def geometry_factors_plain(cell_coords: torch.Tensor, dphi: torch.Tensor,
                           w: torch.Tensor, clamp: bool = True):
    """The plain version of :func:`geometry_factors`: J summed over the
    vertices in basix order on the coordinates relative to vertex 0, det J
    and the adjugate inverse (wavecore's formula), G = K K^T |det J| w."""
    X = cell_coords - cell_coords[:, :1, :]
    nc, nq = X.shape[0], w.shape[0]
    J = X.new_zeros((nc, nq, 3, 3))
    for n in range(1, 8):  # J[c, q, i, j] += X[c, n, i] dphi[j, q, n]
        J += X[:, None, n, :, None] * dphi[:, :, n].T[None, :, None, :]
    j00, j01, j02 = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    j10, j11, j12 = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    j20, j21, j22 = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    det = (j00 * (j11 * j22 - j12 * j21) - j01 * (j10 * j22 - j12 * j20)
           + j02 * (j10 * j21 - j11 * j20))
    if bool((det == 0).any()):
        raise ValueError("singular Jacobian in mesh")
    inv = 1.0 / det
    K = torch.stack([
        torch.stack([(j11 * j22 - j12 * j21) * inv, (j02 * j21 - j01 * j22) * inv,
                     (j01 * j12 - j02 * j11) * inv], dim=-1),
        torch.stack([(j12 * j20 - j10 * j22) * inv, (j00 * j22 - j02 * j20) * inv,
                     (j02 * j10 - j00 * j12) * inv], dim=-1),
        torch.stack([(j10 * j21 - j11 * j20) * inv, (j01 * j20 - j00 * j21) * inv,
                     (j00 * j11 - j01 * j10) * inv], dim=-1),
    ], dim=-2)
    dw = det.abs() * w
    G = dw[..., None, None] * (K[..., :, None, :] * K[..., None, :, :]).sum(-1)
    return (clamp_plain(G) if clamp else G), dw


def geometry_launch_shape(nq: int) -> tuple[int, int, int]:
    """(points a block's tile takes, cells a pass of a block takes,
    shared-memory bytes) of ``geometry_factors_kernel``: the tile's dphi
    [3, 8, qt], a pass's cell coordinates [cb, 8, 3] and G [cb, qt, 9] in
    f64."""
    qt = min(nq, GEOMETRY_TILE)
    cb = min(THREADS // qt, 64)
    return qt, cb, (24 * (qt + cb) + 9 * qt * cb) * 8


def geometry_launch_args(cell_coords, dphi, w, clamp, G, detJw, singular) -> tuple:
    """The arguments of the C launcher ``wave_geometry_factors`` up to the
    stream."""
    nq = w.shape[0]
    qt, cb, smem = geometry_launch_shape(nq)
    return (cell_coords, dphi, w, cell_coords.shape[0], nq, qt, cb, int(clamp), G,
            detJw, singular, smem)


def geometry_factors_cuda(cell_coords: torch.Tensor, dphi: torch.Tensor,
                          w: torch.Tensor, clamp: bool = True):
    """:func:`geometry_factors` with ``geometry_factors_kernel`` (one
    launch; one count). Raises a ValueError on a zero determinant."""
    dev = cell_coords.device
    nc, nq = cell_coords.shape[0], w.shape[0]
    _cuda.check_typed_operands(dev, F64, cell_coords=(cell_coords, (nc, 8, 3)),
                               dphi=(dphi, (3, nq, 8)), w=(w, (nq,)))
    G = torch.empty((nc, nq, 3, 3), dtype=F64, device=dev)
    detJw = torch.empty((nc, nq), dtype=F64, device=dev)
    singular = torch.zeros(1, dtype=torch.int32, device=dev)
    _cuda.launch("wave_geometry_factors", None, dev,
                 *geometry_launch_args(cell_coords, dphi, w, clamp, G, detJw, singular))
    geometry_factors_cuda.launches += 1
    if int(singular.item()):
        raise ValueError("singular Jacobian in mesh")
    return G, detJw


#: process-wide count of geometry_factors_kernel launches
geometry_factors_cuda.launches = 0


def geometry_factors(cell_coords: torch.Tensor, dphi: torch.Tensor, w: torch.Tensor,
                     clamp: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(G [nc, nq, 3, 3], detJw [nc, nq]), float64, of the cells
    ``cell_coords`` [nc, 8, 3] (basix vertex order) with the coordinate-basis
    gradients ``dphi`` [3, nq, 8] and weights ``w`` [nq]: G = J^-1 J^-T
    |det J| w, clamped at -1/0/1 unless ``clamp`` is False. Raises
    ``ValueError("singular Jacobian in mesh")`` on det J = 0."""
    return _dispatch("geometry_factors", cell_coords, geometry_factors_plain,
                     geometry_factors_cuda, cell_coords, dphi, w, clamp)


# -- node keys -------------------------------------------------------------
#: cells a chunk of :func:`node_keys_plain` takes (its products are nc nd 24
#: doubles)
KEY_CHUNK = 4096


def node_keys_plain(cell_coords: torch.Tensor, phi: torch.Tensor, scale: float,
                    tol: float):
    """The plain version of :func:`node_keys`, in the kernel's order: the
    eight products of a component sorted by value and summed in that order,
    each product and sum rounded on its own, so the two agree bit for bit."""
    inv = 1.0 / (scale * tol)
    parts = []
    for c in range(0, cell_coords.shape[0], KEY_CHUNK):
        prod = phi[None, :, :, None] * cell_coords[c : c + KEY_CHUNK, None]
        prod = torch.sort(prod, dim=2).values  # [n, nd, 8, 3]
        x = prod[:, :, 0]
        for v in range(1, 8):
            x = x + prod[:, :, v]
        parts.append(x.reshape(-1, 3))
    coords = torch.cat(parts)
    return torch.round(coords * inv).to(torch.int64), coords


def node_keys_cuda(cell_coords: torch.Tensor, phi: torch.Tensor, scale: float,
                   tol: float):
    """:func:`node_keys` with ``node_keys_kernel`` (one launch; one count)."""
    dev = cell_coords.device
    nc, nd = cell_coords.shape[0], phi.shape[0]
    _cuda.check_typed_operands(dev, F64, cell_coords=(cell_coords, (nc, 8, 3)),
                               phi=(phi, (nd, 8)))
    keys = torch.empty((nc * nd, 3), dtype=torch.int64, device=dev)
    coords = torch.empty((nc * nd, 3), dtype=F64, device=dev)
    _cuda.launch("wave_node_keys", None, dev, cell_coords, phi, nc, nd,
                 1.0 / (scale * tol), keys, coords)
    node_keys_cuda.launches += 1
    return keys, coords


#: process-wide count of node_keys_kernel launches
node_keys_cuda.launches = 0


def node_keys(cell_coords: torch.Tensor, phi: torch.Tensor, scale: float,
              tol: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys [nc nd, 3] int64, coords [nc nd, 3] float64) of the nodes
    ``phi`` [nd, 8] (trilinear basis values, basix vertex order) of the
    cells ``cell_coords`` [nc, 8, 3], flat cell-major: x = sum_v phi[n, v]
    X[c, v] and key = rint(x / (scale tol)) (``build_dofmap``'s
    quantization, the product by 1 / (scale tol)). The eight products of a
    component are summed in ascending order of value, an order that does not
    depend on how the cell lists its vertices: with ``phi`` tabulated at
    nodes whose mirror images are nodes bit for bit
    (``core.dofmap.node_phi``), the copies of a node shared by several cells
    get one coordinate, and so one key, however each cell is oriented."""
    return _dispatch("node_keys", cell_coords, node_keys_plain, node_keys_cuda,
                     cell_coords, phi, scale, tol)


# -- dof dedup ---------------------------------------------------------------
def _number_by_first(rep: torch.Tensor, return_first: bool):
    """(ids int32, ndofs[, first]) from rep[i], the flat index of the first
    node of i's key: ids = the exclusive scan of (rep == i) taken at rep;
    ``first`` lists each dof's first node, in id order."""
    n = rep.shape[0]
    is_first = rep == torch.arange(n, device=rep.device)
    pos = torch.cumsum(is_first, 0)
    ids = (pos - 1)[rep].to(torch.int32)
    ndofs = int(pos[-1]) if n else 0
    if return_first:
        return ids, ndofs, torch.nonzero(is_first).reshape(-1)
    return ids, ndofs


def dedup_dofs_plain(keys: torch.Tensor, return_first: bool = False):
    """The plain version of :func:`dedup_dofs`: ``torch.unique`` of the rows
    and a ``scatter_reduce('amin')`` of the flat index per key."""
    n = keys.shape[0]
    _, inv = torch.unique(keys, dim=0, return_inverse=True)
    nu = int(inv.max()) + 1 if n else 0
    idx = torch.arange(n, device=keys.device)
    first = torch.full((nu,), n, dtype=torch.int64, device=keys.device)
    first = first.scatter_reduce(0, inv.reshape(-1), idx, "amin")
    return _number_by_first(first[inv.reshape(-1)], return_first)


def dedup_table_size(n: int) -> int:
    """Slots of the dedup hash table for n keys: a power of two >= 2n
    (at least 1024)."""
    return max(1024, 1 << max(2 * n - 1, 1).bit_length())


def dedup_dofs_cuda(keys: torch.Tensor, return_first: bool = False):
    """:func:`dedup_dofs` with ``dedup_insert_kernel`` then
    ``dedup_lookup_kernel`` (one launcher call; one count). Raises where
    the hash table fills."""
    dev = keys.device
    n = keys.shape[0]
    _cuda.check_typed_operands(dev, torch.int64, keys=(keys, (n, 3)))
    size = dedup_table_size(n)
    table = torch.full((size,), -1, dtype=torch.int64, device=dev)  # ~0: empty
    rep = torch.empty(n, dtype=torch.int64, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    _cuda.launch("wave_dedup_hash", None, dev, keys, n, table, size - 1, rep, overflow)
    dedup_dofs_cuda.launches += 1
    if int(overflow.item()):
        raise RuntimeError(f"dedup hash table of {size} slots found no slot for "
                           f"a key of {n}")
    return _number_by_first(rep, return_first)


#: process-wide count of dedup launcher calls (an insert and a lookup launch each)
dedup_dofs_cuda.launches = 0


def dedup_dofs(keys: torch.Tensor, return_first: bool = False):
    """(ids [n] int32, ndofs) of the int64 keys [n, 3]: equal keys share an
    id, ids numbered by first appearance in the flat order (wavecore's
    ``dedup_dofs``). With ``return_first``, also each dof's first flat
    index, in id order."""
    return _dispatch("dedup_dofs", keys, dedup_dofs_plain, dedup_dofs_cuda, keys,
                     return_first)


# -- the box's cells -------------------------------------------------------
#: basix hexahedron vertex offsets (x, y, z)
_HEX_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def box_cells(nx: int, ny: int, nz: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """[nx ny nz, 8] int64 basix-ordered vertex ids of a structured box,
    cells x slowest, vertices in C order of the (nx+1, ny+1, nz+1) grid
    (wavecore's ``box_cells``; plain torch on every device)."""
    ar = [torch.arange(n, dtype=torch.int64, device=device) for n in (nx, ny, nz)]
    i, j, k = (a.reshape(-1, 1) for a in torch.meshgrid(*ar, indexing="ij"))
    off = torch.tensor(_HEX_OFFSETS, dtype=torch.int64, device=device)
    return ((i + off[:, 0]) * (ny + 1) + j + off[:, 1]) * (nz + 1) + k + off[:, 2]
