"""Checkpoint and resume of the time-stepping state (u, v, t).

Port of ``wave_fenics_tpu.utils.checkpoint`` in the JAX package's ``.npz``
format: keys ``u`` and ``v`` (host arrays) and ``meta`` (a JSON string
holding ``t`` and any caller metadata), so ``save_state``/``load_state``
files cross between the packages both ways. ``CheckpointManager`` keeps the
JAX package's ``step_{:09d}`` naming and its ``keep`` garbage collection;
its snapshots are ``step_{:09d}.npz`` files. The JAX package's manager
writes orbax directories where orbax is installed; the port carries no
orbax, so its manager raises on a directory that holds them instead of
starting again from step 0.

A bf16 state (NumPy has no bf16) is stored as its bit pattern, ``uint16``
arrays with ``"state_dtype": "bfloat16"`` in ``meta``, and comes back as
CPU bf16 tensors bit for bit; every other state as it is.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import to_numpy_bits

__all__ = ["save_state", "load_state", "CheckpointManager"]


_BF16 = "bfloat16"


def _host(x) -> np.ndarray:
    """A state as a host array: a bf16 tensor as its bits (uint16)."""
    return to_numpy_bits(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _from_host(a: np.ndarray, dtype: str | None):
    if dtype == _BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, u, v, t: float, meta: dict | None = None) -> None:
    """Write one snapshot to ``path`` (``.npz`` appended if missing)."""
    meta = dict(meta or {}, t=float(t))
    bf16 = [isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 for x in (u, v)]
    if any(bf16):
        if not all(bf16):
            raise ValueError("a snapshot holds u and v of one dtype")
        meta["state_dtype"] = _BF16
    np.savez(_npz(path), u=_host(u), v=_host(v), meta=json.dumps(meta))


def load_state(path: str):
    """(u, v, t, meta) of a snapshot, u and v as host NumPy arrays (a bf16
    snapshot's as CPU bf16 tensors, bit for bit)."""
    data = np.load(_npz(path), allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    dtype = meta.pop("state_dtype", None)
    return (_from_host(data["u"], dtype), _from_host(data["v"], dtype), meta.pop("t"),
            meta)


@dataclass
class CheckpointManager:
    """Periodic snapshots of a chunked run in ``directory``; ``restore``
    returns the latest, and ``save`` keeps the ``keep`` newest."""

    directory: str
    every_steps: int = 1000
    keep: int = 3

    def _path(self, step: int) -> str:
        return os.path.join(os.path.abspath(self.directory), f"step_{step:09d}.npz")

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        names = [d for d in os.listdir(self.directory) if d.startswith("step_")]
        foreign = sorted(d for d in names if not d.endswith(".npz"))
        if foreign:
            raise ValueError(
                f"{self.directory} holds snapshots that are not .npz files "
                f"({', '.join(foreign)}): orbax checkpoints of the JAX package's "
                "CheckpointManager; the port reads only save_state .npz snapshots")
        return sorted(int(d[len("step_"):-len(".npz")]) for d in names)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, u, v, t: float, meta: dict | None = None) -> None:
        os.makedirs(self.directory, exist_ok=True)
        save_state(self._path(step), u, v, t, meta)
        for s in self._steps()[: -self.keep]:
            os.remove(self._path(s))

    def restore(self):
        """(step, u, v, t, meta) of the latest snapshot, or None."""
        step = self.latest_step()
        if step is None:
            return None
        u, v, t, meta = load_state(self._path(step))
        return step, u, v, t, meta
