"""Linear wave model on general (imported or unstructured) hex meshes.

Port of ``wave_fenics_tpu.models.general_wave`` (``GeneralLinearWave``,
``facet_lumped_weights``): the LinearGLL physics of ``models.linear_wave``
on any ``core.mesh.HexMesh`` with tagged exterior quad facets, through the
explicit-dofmap operators (``ops.operators.GeneralOperators``; kernel K on
a card). It completes the reference's mesh-agnostic driver
(demo/cpu_planar3d/main.cpp:39-45 reads an arbitrary XDMF hex mesh and its
facet tags): ``from_xdmf`` builds the model from those two files (or
``convert.general_mesh_from_numpy`` carries a mesh across), and
``probe_dofs``/``solve_recording`` record pressure time series at probe
points on the device.

Boundary facet integrals are assembled once at setup by GLL facet
quadrature on each tagged bilinear facet: with collocation the integral is
diagonal, so each facet contributes w_i w_j |J_s(x_ij)| to the dof at its
(i, j) facet node, |J_s| = |dx/du x dx/dv| the surface element. Facet nodes
are matched to volume dofs by the dofmap's quantized geometric key (exact
for trilinear cells). Time is a Python float, as in ``LinearWave``.

The model's set-up runs on its ``device``: the dofmap, the geometry
factors, the affine test, the lumped mass and the facet weights
(``build_dofmap``, ``GeneralOperators`` and ``facet_lumped_weights`` with
``device=``: the hand-written set-up kernels of ``native`` on a card, their
plain versions on the CPU). The NumPy route of each (``device=None``) stays
as the oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core.basis import gll_points_weights, tabulate_1d
from ..core.dofmap import GeneralDofMap, build_dofmap, node_phi, node_sums
from ..core.io import QUAD_VTK_TO_BASIX, read_xdmf, read_xdmf_meshtags
from ..core.mesh import HEX_FACES, HexMesh
from ..ops import gather_scatter as gs
from ..ops.operators import GeneralOperators
from ..solvers.leapfrog import leapfrog_solve_n, leapfrog_solve_n_recording
from ..solvers.rk4 import rk4_solve_n, rk4_solve_n_recording
from .linear_wave import WavePhysics

__all__ = ["GeneralLinearWave", "facet_lumped_weights", "check_exterior_facets",
           "read_mesh_and_tags", "from_xdmf", "probe_dofs", "solve_recording"]


_UNMATCHED_FACET = ("facet node does not coincide with a volume dof: facet vertex "
                    "ordering or mesh/tag mismatch")


def facet_lumped_weights(
    mesh: HexMesh,
    dofs: GeneralDofMap,
    facets: np.ndarray,
    p: int,
    tol: float = 1e-9,
    rule: str = "gll",
    qdeg: int | None = None,
    device: torch.device | str | None = None,
):
    """Lumped facet-mass vector W[ndofs]: over the given facets [n, 4] (basix
    quad vertex order), W_i = the integral of phi_i |J_s| over the facet,
    accumulated at the matching volume dofs.

    ``rule='gll'`` (default, the reference's): diagonal GLL facet quadrature,
    W at facet node (i, j) is w_i w_j |J_s(x_ij)|. ``rule='gauss'``: |J_s|
    at tensor Gauss points, row-sum lumped, W[i, j] = sum_ab qw_a qw_b
    B[a, i] B[b, j] |J_s(u_a, v_b)| (the companion of the Gauss-rule volume
    operators).

    Every facet node is keyed as the dofmap keys its nodes
    (``_facet_node_sums``, quantized as ``build_dofmap`` quantizes).
    ``device=None``: NumPy, the facet keys matched by a sort and a search
    against the keys of the dofs' sorted sums.
    A device: a float64 tensor there, the JAX package's native route: one
    ``native.dedup_dofs`` over [the dof keys; the facet keys], where an id
    >= ndofs is a facet node that matches no dof; ``dofs`` must have been
    built on that device (its ``device_keys``)."""
    if device is not None:
        return _facet_weights_tensors(mesh, dofs, facets, p, tol, rule, qdeg,
                                      torch.device(device))
    nodes, w1d = gll_points_weights(p + 1)
    U, V = np.meshgrid(nodes, nodes, indexing="ij")
    u = U.ravel()
    v = V.ravel()

    scale = max(np.abs(mesh.points).max(), 1.0)
    inv = 1.0 / (scale * tol)
    cells = mesh.cells if dofs.cell_order is None else mesh.cells[dofs.cell_order]
    keys = np.empty((dofs.ndofs, 3), dtype=np.int64)
    keys[dofs.dofmap.reshape(-1)] = np.rint(
        node_sums(node_phi(p), mesh.points[cells]).reshape(-1, 3) * inv)

    fa = np.asarray(facets)
    fc = mesh.points[fa]  # [nf, 4, 3]
    v0, v1, v2, v3 = (fc[:, i, None, :] for i in range(4))

    def surf(uu, vv):
        """The bilinear facet map's surface element at parameter points."""
        xu = (1 - vv) * (v1 - v0) + vv * (v3 - v2)
        xv = (1 - uu) * (v2 - v0) + uu * (v3 - v1)
        return np.linalg.norm(np.cross(xu, xv), axis=-1)  # [nf, npt]

    Js = surf(u[None, :, None], v[None, :, None])
    if rule == "gll":
        Wf = np.outer(w1d, w1d).ravel()[None, :] * Js  # [nf, nd2]
    elif rule == "gauss":
        tab = tabulate_1d(p, qdeg, "gauss")
        Uq, Vq = np.meshgrid(tab.qpts, tab.qpts, indexing="ij")
        Jg = surf(Uq.ravel()[None, :, None], Vq.ravel()[None, :, None])
        Jg = Jg.reshape(len(fa), tab.nq, tab.nq)
        Wf = np.einsum("ai,bj,a,b,fab->fij", tab.B, tab.B, tab.qwts, tab.qwts,
                       Jg).reshape(len(fa), -1)
    else:
        raise ValueError(f"unknown quadrature rule {rule!r}")
    fkeys = np.rint(_facet_node_sums(mesh, fa, p) * inv).astype(np.int64)
    # match facet keys to dof keys: sort the dof keys as records, search
    kv = np.ascontiguousarray(keys).view([("", np.int64)] * 3).reshape(-1)
    order = np.argsort(kv)
    sk = kv[order]
    fv = np.ascontiguousarray(fkeys).view([("", np.int64)] * 3).reshape(-1)
    pos = np.searchsorted(sk, fv)
    ok = (pos < len(sk)) & (sk[np.minimum(pos, len(sk) - 1)] == fv)
    ids = order[np.minimum(pos, len(sk) - 1)]
    if not ok.all():
        raise ValueError(_UNMATCHED_FACET)
    W = np.zeros(dofs.ndofs)
    np.add.at(W, ids, Wf.ravel())
    return W


def _facet_node_sums(mesh: HexMesh, facets, p: int) -> np.ndarray:
    """[nf (p+1)^2, 3] the facets' GLL nodes as the dofmap computes them
    (``node_sums`` on ``node_phi``'s mirrored nodes): each facet [4] in
    basix quad order is the z = 0 face of a flat cell whose z = 1 face is the
    same four vertices, so a node's four nonzero products are those of the
    volume cells that share the facet and its four others are 0, and the
    node gets its dof's coordinate, and key, bit for bit. (The bilinear
    facet map computes the coordinate a third way, which can round to
    another key where the node lies at a key's .5 boundary.)"""
    fc = mesh.points[np.asarray(facets)]
    phi = node_phi(p)[:: p + 1]  # the nodes at z = 0, x slowest
    return node_sums(phi, np.concatenate([fc, fc], axis=1)).reshape(-1, 3)


def _facet_weights_tensors(mesh: HexMesh, dofs: GeneralDofMap, facets, p: int,
                           tol: float, rule: str, qdeg: int | None,
                           device: torch.device) -> torch.Tensor:
    """The device route of :func:`facet_lumped_weights`: the NumPy route's
    arithmetic in torch on ``device``, the facet nodes matched by one dedup
    over [dof keys; facet keys], the weights added in the NumPy route's
    order (``scatter_ordered``)."""
    keys = dofs.device_keys
    if keys is None or keys.device.type != device.type:
        raise ValueError(f"facet weights on {device} match facet nodes against the "
                         "keys of a dofmap built there (build_dofmap(..., device=...))")
    dev = keys.device

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)

    nodes, w1d = gll_points_weights(p + 1)
    U, V = np.meshgrid(nodes, nodes, indexing="ij")
    u, v = t(U.ravel())[None, :, None], t(V.ravel())[None, :, None]
    inv = 1.0 / (max(np.abs(mesh.points).max(), 1.0) * tol)
    fa = torch.as_tensor(np.asarray(facets, dtype=np.int64), device=dev)
    fc = t(mesh.points)[fa]  # [nf, 4, 3]
    v0, v1, v2, v3 = (fc[:, i, None, :] for i in range(4))

    def surf(uu, vv):
        """The bilinear facet map's surface element at parameter points."""
        xu = (1 - vv) * (v1 - v0) + vv * (v3 - v2)
        xv = (1 - uu) * (v2 - v0) + uu * (v3 - v1)
        cr = torch.stack([xu[..., 1] * xv[..., 2] - xu[..., 2] * xv[..., 1],
                          xu[..., 2] * xv[..., 0] - xu[..., 0] * xv[..., 2],
                          xu[..., 0] * xv[..., 1] - xu[..., 1] * xv[..., 0]], dim=-1)
        return torch.sqrt((cr * cr).sum(-1))

    Js = surf(u, v)
    nf = fa.shape[0]
    if rule == "gll":
        Wf = t(np.outer(w1d, w1d).ravel())[None, :] * Js  # [nf, nd2]
    elif rule == "gauss":
        tab = tabulate_1d(p, qdeg, "gauss")
        Uq, Vq = np.meshgrid(tab.qpts, tab.qpts, indexing="ij")
        Jg = surf(t(Uq.ravel())[None, :, None], t(Vq.ravel())[None, :, None])
        B, qw = t(tab.B), t(tab.qwts)
        Wf = torch.einsum("ai,bj,a,b,fab->fij", B, B, qw, qw,
                          Jg.reshape(nf, tab.nq, tab.nq)).reshape(nf, -1)
    else:
        raise ValueError(f"unknown quadrature rule {rule!r}")
    fkeys = torch.as_tensor(np.rint(_facet_node_sums(mesh, facets, p) * inv),
                            dtype=torch.int64, device=dev)
    ids, _ = native.dedup_dofs(torch.cat([keys, fkeys]))
    ids = ids[keys.shape[0]:]
    if bool((ids >= dofs.ndofs).any()):
        raise ValueError(_UNMATCHED_FACET)
    return gs.scatter_ordered(Wf, ids, dofs.ndofs)


class GeneralLinearWave(WavePhysics):
    """LinearGLL physics on a general hex mesh (flat dof vectors).

    ``facet_tags``: dict tag -> facet vertex array [n, 4]; tag 1 = source,
    tag 2 = absorbing (forms.ufl:21-24), overridable. ``c0_cells``
    (optional, [ncells]) is a per-cell sound speed; ``c0`` stays the
    reference speed of the source and absorbing terms. ``quadrature``:
    'gll' (the reference's: collocated quadrature and lumped mass) or
    'gauss' (Gauss-rule stiffness, row-sum-lumped Gauss mass and Gauss facet
    weights), with ``quadrature_degree`` (None -> 2p: p+1 points). ``m``,
    ``inv_m``, ``W1`` and ``W2`` are buffers on ``device`` (the card unless
    the caller asks for the CPU). ``dtype`` is float32, float64 or bfloat16
    (bf16 state: kernel K's bf16 form, ``m`` rounded once from its float64
    sum, ``inv_m`` = 1/m, ``W1`` and ``W2`` rounded once from float64 and
    the damping c0 W2 inv_m formed in bf16, and c0^2 g(t) rounded to bf16,
    where the JAX package rounds them; -c0^2 stays float32, where the JAX
    package rounds c0 to bf16 first).
    """

    def __init__(
        self,
        mesh: HexMesh,
        p: int,
        facet_tags: dict,
        c0: float = 1500.0,
        freq0: float = 0.5e6,
        p0: float = 60000.0,
        alpha: float = 4.0,
        source_tag: int = 1,
        abc_tag: int = 2,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cuda",
        c0_cells=None,
        quadrature: str = "gll",
        quadrature_degree: int | None = None,
    ):
        super().__init__()
        self.mesh = mesh
        self.p = p
        self.facet_tags = facet_tags
        self.c0 = c0
        self.freq0 = freq0
        self.p0 = p0
        self.alpha = alpha
        self.source_tag = source_tag
        self.abc_tag = abc_tag
        self.dtype = dtype
        self.c0_cells = c0_cells
        self.quadrature = quadrature
        self.quadrature_degree = quadrature_degree
        dev = torch.device(device)
        self.dofs = build_dofmap(mesh, p, device=dev)
        coeff = None if c0_cells is None else (np.asarray(c0_cells) / c0) ** 2
        self.ops = GeneralOperators(mesh, self.dofs, dtype=dtype, coeff_cells=coeff,
                                    rule=quadrature, q=quadrature_degree, device=dev)
        m = self.ops.lumped_mass_on(dev)
        self.register_buffer("m", m)
        self.register_buffer("inv_m", 1.0 / m)
        self.register_buffer("W1", self._tag_weights(source_tag, dev).to(dtype))
        self.register_buffer("W2", self._tag_weights(abc_tag, dev).to(dtype))

    @property
    def ndofs(self) -> int:
        return self.dofs.ndofs

    def _tag_weights(self, tag: int, device: torch.device) -> torch.Tensor:
        facets = self.facet_tags.get(tag)
        if facets is None or len(facets) == 0:
            return torch.zeros(self.ndofs, dtype=torch.float64, device=device)
        return facet_lumped_weights(self.mesh, self.dofs, facets, self.p,
                                    rule=self.quadrature, qdeg=self.quadrature_degree,
                                    device=device)

    def zero_state(self) -> tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros(self.ndofs, dtype=self.dtype, device=self.device)
        return z, z

    def solve_n(self, t0: float, dt: float, nsteps: int, u0=None, v0=None,
                integrator: str = "rk4"):
        """Exactly ``nsteps`` fixed steps; returns (u, v). ``integrator``:
        'rk4' (the reference's: 4 stiffness applies per step) or 'leapfrog'
        (2nd order, one apply per step and one at t0; needs dt up to about
        0.71x the RK4 CFL step, solvers/leapfrog.py)."""
        if u0 is None:
            u0, v0 = self.zero_state()
        if integrator == "leapfrog":
            return leapfrog_solve_n(self.force, self.damping, u0, v0, t0, dt, nsteps)
        if integrator == "rk4":
            return rk4_solve_n(self.f0, self.f1, u0, v0, t0, dt, nsteps)
        raise ValueError(f"unknown integrator: {integrator!r}")


def check_exterior_facets(mesh: HexMesh, facets: np.ndarray) -> None:
    """Raise a ValueError unless every facet ([n, 4] vertex ids) is an
    exterior face of the mesh: a face of exactly one cell. A facet that is
    no cell's face, or an interior face, would otherwise take boundary
    weights silently (none, or on an interior plane)."""
    faces = np.sort(np.asarray(mesh.cells)[:, HEX_FACES].reshape(-1, 4), axis=1)
    keys, counts = np.unique(faces, axis=0, return_counts=True)
    exterior = keys[counts == 1]
    fs = np.sort(np.asarray(facets, np.int64).reshape(-1, 4), axis=1)
    row = np.dtype([("", np.int64)] * 4)
    ext = np.ascontiguousarray(exterior, np.int64).view(row).reshape(-1)
    want = np.ascontiguousarray(fs).view(row).reshape(-1)
    bad = ~np.isin(want, ext)
    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} of {len(fs)} tagged facets are not exterior faces "
            f"of the mesh (first: vertices {fs[np.argmax(bad)].tolist()}): the "
            "meshtags do not belong to this mesh")


def read_mesh_and_tags(mesh_path: str, meshtags_path: str | None = None,
                       mesh_grid: str | None = None,
                       tags_grid: str | None = None) -> tuple[HexMesh, dict]:
    """(mesh, facet_tags) from DOLFINx-exported XDMF files: the mesh, and
    tag -> facets [n, 4] in basix quad order, each checked to be an exterior
    face of the mesh (``check_exterior_facets``)."""
    mesh = read_xdmf(mesh_path, mesh_grid)
    facet_tags: dict = {}
    if meshtags_path is not None:
        facets, values = read_xdmf_meshtags(meshtags_path, tags_grid)
        facets = facets[:, QUAD_VTK_TO_BASIX]
        check_exterior_facets(mesh, facets)
        for tag in np.unique(values):
            facet_tags[int(tag)] = facets[values == tag]
    return mesh, facet_tags


def from_xdmf(
    mesh_path: str,
    meshtags_path: str | None = None,
    mesh_grid: str | None = None,
    tags_grid: str | None = None,
    p: int = 4,
    **physics,
) -> GeneralLinearWave:
    """The wave model from DOLFINx-exported XDMF files, the reference's
    workflow (demo/cpu_planar3d/main.cpp:40-45): mesh and boundary
    meshtags in, a model ready to solve out. ``physics`` are the keywords
    of ``GeneralLinearWave`` (``device``, ``dtype``, ``c0``, ...)."""
    mesh, facet_tags = read_mesh_and_tags(mesh_path, meshtags_path, mesh_grid,
                                          tags_grid)
    return GeneralLinearWave(mesh=mesh, p=p, facet_tags=facet_tags, **physics)


def probe_dofs(model: GeneralLinearWave, points) -> np.ndarray:
    """Dof ids nearest to the given physical points: hydrophone placement
    on an imported mesh (the general-mesh analogue of
    ``linear_wave.probe_indices``; the same nearest-GLL-node fidelity)."""
    pts = np.atleast_2d(np.asarray(points, np.float64))
    dc = np.asarray(model.dofs.dof_coords, np.float64)
    return np.array([int(((dc - q) ** 2).sum(axis=1).argmin()) for q in pts],
                    dtype=np.int64)


def solve_recording(
    model: GeneralLinearWave,
    t0: float,
    dt: float,
    nsteps: int,
    points,
    u0=None,
    v0=None,
    integrator: str = "rk4",
):
    """Solve recording the pressure time series at probe points on a
    general mesh. Returns (u, v, series[nsteps, npoints]), the series a
    tensor on the model's device, filled step by step with no host read;
    ``integrator`` as in :meth:`GeneralLinearWave.solve_n`."""
    if u0 is None:
        u0, v0 = model.zero_state()
    ids = torch.as_tensor(probe_dofs(model, points), device=model.device)

    def sample(t, u, v):
        return u[ids]

    if integrator == "leapfrog":
        return leapfrog_solve_n_recording(model.force, model.damping, u0, v0, t0, dt,
                                          nsteps, sample)
    if integrator == "rk4":
        return rk4_solve_n_recording(model.f0, model.f1, u0, v0, t0, dt, nsteps, sample)
    raise ValueError(f"unknown integrator: {integrator!r}")
