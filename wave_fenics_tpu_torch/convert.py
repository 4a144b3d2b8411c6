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

bf16: NumPy has no bfloat16, and the port carries no ``ml_dtypes``. A JAX
bf16 array comes across by its bit pattern (``view(np.uint16)``), bit for
bit (:func:`is_bf16_array`). The port's NumPy table builders compute a bf16
table in float64, with each value the JAX package stores as a bf16 array
rounded to bf16 there (:func:`as_table`); the tensor conversion rounds the
rest once (``torch.tensor(f64).to(torch.bfloat16)``, round to nearest
even through float32, as ``ml_dtypes`` casts).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.mesh import HexMesh
from .parallel.partition import Blocks

__all__ = [
    "numpy_dtype",
    "torch_dtype",
    "table_dtype",
    "as_table",
    "acc_dtype",
    "widen",
    "stored",
    "is_bf16_array",
    "to_numpy_bits",
    "to_numpy",
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


def is_bf16_array(a) -> bool:
    """Whether ``a`` is a NumPy array of a 2-byte ``bfloat16`` type (the
    JAX package's, from ``ml_dtypes``)."""
    return isinstance(a, np.ndarray) and a.dtype.name == "bfloat16" and a.dtype.itemsize == 2


def table_dtype(dtype) -> np.dtype:
    """NumPy dtype the table builders compute a table of ``dtype`` in:
    float64 for bf16, which NumPy lacks (:func:`as_table`), else
    :func:`numpy_dtype`."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float64)
    return numpy_dtype(dtype)


def as_table(a, dtype) -> np.ndarray:
    """``a`` as a NumPy table of ``dtype`` (a builder's ``astype``): for
    bf16, float64 values rounded to bf16, as the JAX package's bf16 table
    holds them; else ``astype(numpy_dtype(dtype))``."""
    if dtype == torch.bfloat16:
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(torch.bfloat16).to(
            torch.float64).numpy()
    return np.asarray(a).astype(numpy_dtype(dtype))


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The arithmetic type of a state of ``dtype``: float32 for bf16 (the
    kernels' Acc<T>, csrc/stencil_tiled.cuh), else ``dtype`` itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def widen(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The tensors in their arithmetic type (:func:`acc_dtype`): the plain
    versions compute a bf16 state in float32, as the kernels do, and round
    only where a kernel stores (:func:`stored`)."""
    return tuple(x.to(acc_dtype(x.dtype)) for x in xs)


def stored(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (in its arithmetic type) as a kernel stores it in ``dtype`` and
    loads it back: rounded to bf16 for a bf16 state, else ``x`` itself."""
    return x.to(dtype).to(x.dtype) if dtype == torch.bfloat16 else x


def to_numpy_bits(x: torch.Tensor) -> np.ndarray:
    """A tensor on the host as NumPy: bf16 as its bit pattern (uint16), the
    other types as they are."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor on the host as NumPy: bf16 widened to float32 (exact), the
    other types as they are."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def torch_dtype(dtype) -> torch.dtype:
    """Torch dtype of a NumPy dtype (or a torch dtype, returned as is; a
    ``bfloat16`` NumPy dtype, the JAX package's, is torch.bfloat16)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    npdt = np.dtype(dtype)
    if npdt.name == "bfloat16" and npdt.itemsize == 2:
        return torch.bfloat16
    for tdt, ndt in _TORCH_TO_NUMPY.items():
        if ndt == npdt:
            return tdt
    raise ValueError(f"unsupported dtype {npdt} (float32 or float64)")


def tables_from_numpy(tables, device, dtype) -> tuple[torch.Tensor, ...]:
    """NumPy tables (e.g. from ``build_step_tables``), or tensors, ->
    contiguous tensors of ``dtype`` on ``device``."""
    dt = torch_dtype(dtype)
    return tuple(_tensor(t, device, dt) for t in tables)


def _tensor(t, device, dt) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=dt).contiguous()
    a = np.ascontiguousarray(t)
    if is_bf16_array(a):  # by its bit pattern
        x = torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
        return x.to(device=device, dtype=dt).contiguous()
    if dt == torch.bfloat16:  # one rounding from float64
        return torch.as_tensor(a, dtype=torch.float64).to(dt).to(device).contiguous()
    return torch.as_tensor(a, dtype=dt, device=device)


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
