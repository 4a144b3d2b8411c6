"""Carry tables and state across from the JAX package's NumPy arrays.

The JAX package's table functions and solvers hand out NumPy arrays (or
``np.asarray`` of a device array); these helpers turn them into the
port's tensors on an explicit device and dtype, so the same tables and
the same padded state can drive both implementations. A general hex mesh
and its facet tags come across as NumPy arrays
(:func:`general_mesh_from_numpy`): they are the general-mesh path's input,
from which the port builds its own dofmap, geometry and tables. A blocked
array of the JAX package's distributed models (``[mx, my, mz, ...]``)
comes across as the port's per-block tensors (:func:`blocked_from_numpy`)
and goes back (:func:`blocked_to_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.mesh import HexMesh
from .parallel.partition import Blocks

__all__ = [
    "numpy_dtype",
    "torch_dtype",
    "tables_from_numpy",
    "state_from_numpy",
    "general_mesh_from_numpy",
    "blocked_from_numpy",
    "blocked_to_numpy",
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
    """NumPy tables (e.g. from ``build_step_tables``), or tensors, ->
    contiguous tensors of ``dtype`` on ``device``."""
    dt = torch_dtype(dtype)
    return tuple(
        t.to(device=device, dtype=dt).contiguous() if isinstance(t, torch.Tensor)
        else torch.as_tensor(np.ascontiguousarray(t), dtype=dt, device=device)
        for t in tables
    )


def state_from_numpy(u, v, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """A padded state (u, v) as NumPy arrays -> two contiguous tensors."""
    u_t, v_t = tables_from_numpy((u, v), device, dtype)
    return u_t, v_t


def general_mesh_from_numpy(points, cells, facet_tags=None) -> tuple[HexMesh, dict]:
    """A hex mesh as arrays (``points`` [n, 3], ``cells`` [nc, 8] in basix
    vertex order, e.g. a JAX package ``HexMesh``'s) and its facet tags
    (tag -> [n, 4] facet vertex ids) -> (the port's ``HexMesh``, a dict of
    int64 facet arrays), copied."""
    mesh = HexMesh(points=np.array(points, dtype=np.float64),
                   cells=np.array(cells, dtype=np.int64))
    tags = {int(t): np.array(f, dtype=np.int64) for t, f in (facet_tags or {}).items()}
    return mesh, tags


def blocked_from_numpy(blocked, devices, dtype) -> Blocks:
    """A JAX blocked array ``[mx, my, mz, ...]`` -> the port's ``Blocks``:
    block (bx, by, bz) at C-order index (bx * my + by) * mz + bz, a
    contiguous copy of ``dtype`` on ``devices[b]`` (one device for all
    when ``devices`` is a single device)."""
    a = np.asarray(blocked)
    mx, my, mz = a.shape[:3]
    n = mx * my * mz
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    flat = a.reshape(n, *a.shape[3:])
    return Blocks(torch.tensor(flat[b], dtype=torch_dtype(dtype), device=devices[b])
                  for b in range(n))


def blocked_to_numpy(blocks, parts) -> np.ndarray:
    """The port's ``Blocks`` (every block held) -> a JAX-style blocked
    array ``[mx, my, mz, ...]``."""
    arrs = [x.detach().cpu().numpy() for x in blocks]
    return np.stack(arrs).reshape(*parts, *arrs[0].shape)
