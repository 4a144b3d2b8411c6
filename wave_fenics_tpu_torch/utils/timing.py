"""Timing utilities (the dolfinx ``common::Timer`` / ``MPI_Wtime`` analogue).

Port of ``wave_fenics_tpu.utils.timing``. PyTorch returns before the card
finishes, so a host clock is read only after ``torch.cuda.synchronize()``
(:class:`Timer`); kernel times come from CUDA events (:func:`timeit`).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

__all__ = ["sync", "Timer", "timeit"]


def sync(device: torch.device | str | None = None) -> None:
    """Wait for all queued work on ``device`` (a no-op for the CPU)."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(dev)


class Timer:
    """Named accumulating host-clock timers (dolfinx ``list_timings``
    analogue); each interval starts and ends in a sync."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = device
        self._acc: dict[str, float] = defaultdict(float)
        self._n: dict[str, int] = defaultdict(int)

    @contextmanager
    def __call__(self, name: str):
        sync(self.device)
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self._acc[name] += time.perf_counter() - t0
        self._n[name] += 1

    def seconds(self, name: str) -> float:
        return self._acc[name]


def timeit(fn, *args, reps: int = 20, warmup: int = 3) -> float:
    """Seconds per call of ``fn(*args)`` on the current CUDA device: CUDA
    events around ``reps`` back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps / 1e3
