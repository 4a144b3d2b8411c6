"""Element-assembled and globally assembled operators: the baselines
beside the matrix-free operators.

Port of ``wave_fenics_tpu.ops.assembled``: dense per-element matrices A_e
(``assemble_element_tensors``, assemble_element_tensor semantics,
common/precompute.hpp:202-232);

- ``EAOperator``: the stored-A_e matvec y = scatter(A_e @ gather(x)) (the
  reference's EA operator, demo/gpu_cg/operators.hpp:127-201), one batched
  product over all cells (``torch.bmm``, as the JAX package's einsum at
  HIGHEST precision: TF32 must be off on a card), gathered and scattered
  through ``ops.gather_scatter``;
- ``assemble_csr``: A_e summed into one SciPy CSR matrix (the PETScOperator
  baseline, operators.hpp:72-124); on a card its matvec is one PyTorch call
  (``csr_tensor``: ``torch.sparse.mm``), which covers the JAX module's
  on-device BCOO matvec. Both are yardsticks beside kernel K, which
  computes the same operator matrix-free.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..convert import numpy_dtype
from ..core import geometry
from ..core.basis import tabulate_1d
from ..core.dofmap import GeneralDofMap
from ..core.mesh import HexMesh
from . import gather_scatter as gs
from .wave import _check_no_tf32

__all__ = ["assemble_element_tensors", "EAOperator", "assemble_csr", "csr_tensor"]


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


class EAOperator(nn.Module):
    """Element-assembly matvec y = scatter(A_e @ gather(x)) on a flat dof
    vector: A_e [nc, nd, nd] and the dofmap are buffers of the operator
    dtype on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, dofs: GeneralDofMap, A_e: np.ndarray,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.ndofs = dofs.ndofs
        self.dtype = dtype
        self.register_buffer("A_e", torch.as_tensor(
            np.ascontiguousarray(A_e, dtype=numpy_dtype(dtype)), device=device))
        self.register_buffer("dofmap", torch.as_tensor(
            np.ascontiguousarray(dofs.dofmap, dtype=np.int64), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_no_tf32(x)
        xe = gs.gather_indexed(x, self.dofmap)  # [nc, nd]
        ye = torch.bmm(self.A_e, xe[:, :, None])[:, :, 0]
        return gs.scatter_indexed(ye, self.dofmap, self.ndofs)


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
