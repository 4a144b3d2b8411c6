"""Vector algebra on dof grids and vectors (plain torch).

Port of the part of ``wave_fenics_tpu.ops.la`` that CG calls: the
reference's ``linalg::inner_product`` (common/cuda/la.hpp:19-139 and its
fork demo/gpu_cg/CUDA/streaming.hpp:18-138). Single-device tensors have no
ghosts, so no multiplicity weights.
"""

from __future__ import annotations

import torch

from ..convert import widen

__all__ = ["inner_product"]


def inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> over all entries, a 0-d tensor on the inputs' device, in the
    arithmetic type (``convert.acc_dtype``: float32 for bf16 vectors)."""
    return torch.dot(*widen(a.reshape(-1), b.reshape(-1)))
