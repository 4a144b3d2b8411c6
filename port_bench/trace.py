"""Reading the profiler's trace of a few whole solves inside the window.

The harness wraps each solve in three host spans (``torch.profiler.
record_function``): ``port_bench.prep`` (choosing the input),
``port_bench.solve`` (the port's solve call) and ``port_bench.sync``
(the synchronise after it). The traced window runs from the first traced
span's start to the last one's end; every device activity of the traced
solves lies inside it, since each solve ends in a synchronise.

From the trace: the device's busy time (the union of the intervals of
every device activity, kernels and copies, so that overlapping launches
count once), the compute kernels launched, the CUDA runtime's
synchronising calls made inside the solve spans, and the breakdown: the
device operations by total time and the longest idle gaps, each labelled
with the harness span and the innermost host event at its middle.

Kept apart for readers of the program's own spans: the port's host ranges
(``wave.*``, ``utils/profiling.py::annotate``) that lie inside the traced
window, and the merged intervals in which the profiler's ``Command Buffer
Full`` events held the host. Both stay among the host events as well, so
that the readings above do not depend on them.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["Trace", "summarize", "idle_pct", "SYNC_CALLS", "PROGRAM_PREFIX", "BLOCKED"]

#: name prefix of the program's own host spans
PROGRAM_PREFIX = "wave."
#: the profiler's host event while the launch queue is full
BLOCKED = "Command Buffer Full"
#: CUDA runtime calls that block the host until the device catches up
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize"})


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: units of work (steps or iterations) of the traced solves
    units: float
    #: (name, start us, end us) of each compute kernel in the window
    kernels: list = field(default_factory=list)
    #: device seconds of every activity (kernels and copies) by name
    by_name: dict = field(default_factory=dict)
    host_syncs: int = 0
    #: whether the trace held the runtime's API calls at all
    saw_runtime: bool = False
    idle_gaps: list = field(default_factory=list)
    #: (name, start us, end us) of each of the program's spans in the window,
    #: by start (an outer span before the spans it holds)
    program: list = field(default_factory=list)
    #: (start us, end us) of the merged ``Command Buffer Full`` intervals
    #: in the window
    blocked: list = field(default_factory=list)

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": self.idle_gaps[:10]}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _merge(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events, units: float) -> Trace | None:
    """A :class:`Trace` of ``events`` (``profile.events()``: objects with
    ``name``, ``device_type`` and ``time_range``), or None when it holds
    no device activity inside the harness's spans."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, host, dev = [], [], []
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if e.name.startswith("ProfilerStep"):  # the profiler's own step marks
            continue
        if e.name.startswith("port_bench."):
            if e.device_type != cuda:
                spans.append((t0, t1, e.name))
        elif e.device_type == cuda:
            dev.append((t0, t1, e.name))
        else:
            host.append((t0, t1, e.name))
    if not spans:
        return None
    w0 = min(s[0] for s in spans)
    w1 = max(s[1] for s in spans)
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    if not dev:
        return None
    by_name = defaultdict(float)
    for a, b, n in dev:
        by_name[n] += (b - a) * 1e-6
    merged = _merge((a, b) for a, b, _ in dev)
    busy_us = sum(b - a for a, b in merged)
    solve_spans = [(a, b) for a, b, n in spans if n == "port_bench.solve"]
    syncs = sum(1 for a, b, n in host if n in SYNC_CALLS
                and any(s0 <= a < s1 for s0, s1 in solve_spans))
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    return Trace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, units=units,
        kernels=[(n, a, b) for a, b, n in dev if not _is_copy(n)], by_name=dict(by_name),
        host_syncs=syncs, saw_runtime=any(n.startswith("cuda") for _, _, n in host),
        idle_gaps=[[_label(start + length / 2, spans, host), length * 1e-6]
                   for length, start in gaps],
        program=sorted(((n, a, b) for a, b, n in host
                        if n.startswith(PROGRAM_PREFIX) and w0 <= a and b <= w1),
                       key=lambda s: (s[1], -s[2])),
        blocked=[tuple(ab) for ab in _merge((max(a, w0), min(b, w1)) for a, b, n in host
                                            if n == BLOCKED and b > w0 and a < w1)])


def _label(t: float, spans, host) -> str:
    """The harness span at host time t, and the innermost host event
    around t (an operator or a runtime call), as ``span: event``."""
    span = next((n.split(".", 1)[1] for a, b, n in spans if a <= t <= b), "between spans")
    inner = min(((b - a, n) for a, b, n in host if a <= t <= b), default=None)
    return f"{span}: {inner[1]}" if inner else span


def idle_pct(run, per: str) -> float | None:
    """The share of the traced window in which no device activity runs, in
    percent; None without a trace or for a cell whose unit of work is not
    ``per``."""
    t = run.trace
    if run.per != per or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
