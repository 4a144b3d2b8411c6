"""Named host ranges in the profiler's trace, and readings of that trace.

Port of ``wave_fenics_tpu.utils.profiling.annotate`` (the reference's NVTX
ranges around CG's phases, demo/gpu_cg/CUDA/cg.hpp:74-113). The port's
solvers open a span, named with the prefix ``wave.``, around each unit of
work: ``wave.rk4.solve`` and ``wave.rk4.step`` (kernel A or C),
``wave.lf2.solve`` and ``wave.lf2.call`` (kernel I), ``wave.lf.step``
(kernel H), ``wave.cg.solve``, ``wave.cg.iter``, ``wave.cg.stop_test``
and ``wave.cg.matvec``; ``wave.rk4_eager.step`` around each step of the
eager RK4 loop (``solvers/rk4.py``: a general mesh's solve, kernel K's
applies and the stage algebra, or whatever model it steps).

A span is recorded only while a ``torch.profiler`` records; otherwise
``annotate`` hands back one shared no-op context, so a solve that is not
profiled makes no profiler call at all. The profiler is the only switch.
A span is a host range on the profiler's own clock, beside the runtime's
calls and the device's activity, and nests by containment. It has no copy
on the device's timeline (``torch.profiler.record_function`` adds one, a
``gpu_user_annotation`` that spans the kernels it launched), so readers of
the device's intervals see the same events with spans and without.

Not ported: the JAX ``trace`` (``torch.profiler.profile`` is the capture
context), ``step_annotation`` (``profile.step``) and ``xla_dump_flags``
(no XLA).
"""

from __future__ import annotations

import bisect
import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["annotate", "BLOCKED", "host_span_us", "device_busy_us"]

#: the profiler's host event for a launch that waits on a full launch queue
BLOCKED = "Command Buffer Full"

_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A context manager: the host range ``name`` in the trace of the
    ``torch.profiler`` that is recording, or a shared no-op context when
    none is."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(a: float, b: float, merged, starts) -> float:
    """The length of [a, b] that the sorted disjoint ``merged`` cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    us = 0.0
    while i < len(merged) and merged[i][0] < b:
        us += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return us


def host_span_us(events, names, less=()) -> tuple[int, float]:
    """(count, microseconds) of the host events of ``events``
    (``profile.events()``) named in ``names``, each less the part of it
    that host events named in ``less`` cover: a span's self time without
    those children, or, with ``less=(BLOCKED,)``, without the time the
    host waited on a full launch queue."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, cut = [], []
    for e in events:
        if e.device_type == cuda:
            continue
        if e.name in names:
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name in less:
            cut.append((e.time_range.start, e.time_range.end))
    merged = _merged(cut)
    starts = [m[0] for m in merged]
    return len(spans), sum(b - a - _covered(a, b, merged, starts) for a, b in spans)


def device_busy_us(events) -> float:
    """Microseconds in which some device activity of ``events`` runs: the
    union of the device's intervals, so that overlapping launches count
    once."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(b - a for a, b in _merged(
        (e.time_range.start, e.time_range.end) for e in events if e.device_type == cuda))
