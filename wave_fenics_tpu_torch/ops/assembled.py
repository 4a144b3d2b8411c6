"""Globally assembled operators (host, NumPy and SciPy): the sparse baseline.

Port of ``assemble_element_tensors`` and ``assemble_csr`` of
``wave_fenics_tpu.ops.assembled``: dense per-element matrices A_e
(assemble_element_tensor semantics, common/precompute.hpp:202-232) summed
into one CSR matrix (the reference's PETScOperator baseline,
demo/gpu_cg/operators.hpp:72-124). On a card its matvec is one PyTorch call
(``csr_tensor``: ``torch.sparse.mm`` of the assembled matrix), the yardstick
beside kernel K, which computes the same operator matrix-free. The
element-assembly operator (``EAOperator``) and the BCOO matvec are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import geometry
from ..core.basis import tabulate_1d
from ..core.dofmap import GeneralDofMap
from ..core.mesh import HexMesh

__all__ = ["assemble_element_tensors", "assemble_csr", "csr_tensor"]


def _tables_3d(p: int, q: int | None, rule: str):
    tab = tabulate_1d(p, q, rule)
    B, D = tab.B, tab.D
    n3, d3 = tab.nq**3, tab.nd**3
    Phi = np.einsum("qi,rj,sk->qrsijk", B, B, B).reshape(n3, d3)
    dx = np.einsum("qi,rj,sk->qrsijk", D, B, B).reshape(n3, d3)
    dy = np.einsum("qi,rj,sk->qrsijk", B, D, B).reshape(n3, d3)
    dz = np.einsum("qi,rj,sk->qrsijk", B, B, D).reshape(n3, d3)
    return Phi, np.stack([dx, dy, dz])


def assemble_element_tensors(
    mesh: HexMesh, p: int, q: int | None = None, rule: str = "gll",
    kind: str = "mass", coeff: float = 1.0, clamp: bool = False,
) -> np.ndarray:
    """Dense per-element matrices A_e[nc, nd, nd] of the mass or the
    stiffness. The geometry is unclamped, as the JAX package's, unless
    ``clamp``: then it is the matrix-free operators' (and kernel K's), and
    the assembled matrix is their operator."""
    Phi, dPhi = _tables_3d(p, q, rule)
    G, detJw = geometry.precompute_geometric_data(mesh, p, q, rule, clamp=clamp)
    if kind == "mass":
        A = np.einsum("qa,cq,qb->cab", Phi, detJw, Phi, optimize=True)
    elif kind == "stiffness":
        A = np.einsum("dqa,cqde,eqb->cab", dPhi, G, dPhi, optimize=True)
    else:
        raise ValueError(kind)
    return coeff * A


def assemble_csr(dofs: GeneralDofMap, A_e: np.ndarray):
    """The globally assembled SciPy CSR matrix sum_e P_e^T A_e P_e."""
    import scipy.sparse as sp

    nc, nd, _ = A_e.shape
    rows = np.repeat(dofs.dofmap, nd, axis=1).ravel()
    cols = np.tile(dofs.dofmap, (1, nd)).ravel()
    M = sp.coo_matrix((A_e.ravel(), (rows, cols)), shape=(dofs.ndofs, dofs.ndofs))
    return M.tocsr()


def csr_tensor(A, device, dtype: torch.dtype) -> torch.Tensor:
    """A SciPy CSR matrix as a torch sparse CSR tensor on ``device``; its
    matvec is ``torch.sparse.mm(A, x[:, None])``."""
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr, dtype=torch.int64),
        torch.as_tensor(A.indices, dtype=torch.int64),
        torch.as_tensor(A.data, dtype=dtype), size=A.shape,
        check_invariants=False).to(device)
