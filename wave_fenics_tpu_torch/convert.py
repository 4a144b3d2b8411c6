"""Carry tables and state across from the JAX package's NumPy arrays.

The JAX package's table functions and solvers hand out NumPy arrays (or
``np.asarray`` of a device array); these helpers turn them into the
port's tensors on an explicit device and dtype, so the same tables and
the same padded state can drive both implementations.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "numpy_dtype",
    "torch_dtype",
    "tables_from_numpy",
    "state_from_numpy",
]

_TORCH_TO_NUMPY = {
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}


def numpy_dtype(dtype) -> np.dtype:
    """NumPy dtype of a torch dtype, or of anything ``np.dtype`` accepts."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_NUMPY:
            raise ValueError(f"unsupported dtype {dtype} (float32 or float64)")
        return _TORCH_TO_NUMPY[dtype]
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """Torch dtype of a NumPy dtype (or a torch dtype, returned as is)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    npdt = np.dtype(dtype)
    for tdt, ndt in _TORCH_TO_NUMPY.items():
        if ndt == npdt:
            return tdt
    raise ValueError(f"unsupported dtype {npdt} (float32 or float64)")


def tables_from_numpy(tables, device, dtype) -> tuple[torch.Tensor, ...]:
    """NumPy tables (e.g. from ``build_step_tables``) -> contiguous tensors."""
    dt = torch_dtype(dtype)
    return tuple(
        torch.as_tensor(np.ascontiguousarray(t), dtype=dt, device=device)
        for t in tables
    )


def state_from_numpy(u, v, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """A padded state (u, v) as NumPy arrays -> two contiguous tensors."""
    u_t, v_t = tables_from_numpy((u, v), device, dtype)
    return u_t, v_t
