"""The port's own spans (``wave.*``, host ranges with no copy on the
device's timeline) and the profiler's ``Command Buffer Full`` host events
in the trace reading: the busy time, the kernels, the device time by name
and the host syncs read as without them, and an idle gap with no operator
open is labelled with the innermost span."""

from types import SimpleNamespace

import pytest
import torch

from port_bench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, a, b, dev=CPU):
    return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=a, end=b))


BASE = [
    ev("ProfilerStep#2", 0, 1000), ev("ProfilerStep#2", 5, 900, CUDA),
    ev("port_bench.prep", 0, 10), ev("port_bench.solve", 10, 600),
    ev("port_bench.sync", 600, 1000), ev("port_bench.solve", 20, 590, CUDA),
    ev("kernel_a", 100, 300, CUDA), ev("kernel_b", 250, 400, CUDA),
    ev("Memcpy DtoH", 450, 460, CUDA), ev("kernel_a", 700, 900, CUDA),
    ev("cudaStreamSynchronize", 440, 470), ev("cudaDeviceSynchronize", 610, 990),
    ev("aten::add", 410, 440), ev("cudaLaunchKernel", 90, 95),
]
SPANS = [
    ev("wave.cg.solve", 15, 595), ev("wave.cg.iter", 15, 300), ev("wave.cg.iter", 300, 590),
    ev("wave.cg.stop_test", 430, 480), ev("wave.cg.matvec", 85, 98),
    ev("Command Buffer Full", 91, 94),
]


def test_spans_leave_the_device_readings_as_they_are():
    plain = trace.summarize(BASE, units=2.0)
    spanned = trace.summarize(BASE + SPANS, units=2.0)
    assert spanned.window_s == plain.window_s
    assert spanned.busy_s == pytest.approx(plain.busy_s)
    assert spanned.kernels == plain.kernels
    assert spanned.by_name == plain.by_name
    assert spanned.host_syncs == plain.host_syncs == 1
    gaps = spanned.breakdown()["idle_gaps"]
    assert [g[0] for g in gaps] == ["solve: wave.cg.iter", "sync: cudaDeviceSynchronize",
                                    "solve: wave.cg.iter", "solve: aten::add"]
    assert [g[1] for g in gaps] == [g[1] for g in plain.breakdown()["idle_gaps"]]


def test_program_spans_and_blocked_intervals_are_kept_apart():
    """``Trace.program`` holds the program's spans inside the traced window,
    in order of their start (an outer span first), and ``Trace.blocked``
    the merged ``Command Buffer Full`` intervals, cut to the window."""
    extra = [ev("wave.cg.iter", 1200, 1300), ev("Command Buffer Full", 92, 97),
             ev("Command Buffer Full", 990, 1100), ev("Command Buffer Full", 200, 210)]
    t = trace.summarize(BASE + SPANS + extra, units=2.0)
    assert t.program == [("wave.cg.solve", 15, 595), ("wave.cg.iter", 15, 300),
                         ("wave.cg.matvec", 85, 98), ("wave.cg.iter", 300, 590),
                         ("wave.cg.stop_test", 430, 480)]
    assert t.blocked == [(91, 97), (200, 210), (990, 1000)]
    plain = trace.summarize(BASE, units=2.0)
    assert (plain.program, plain.blocked) == ([], [])
    assert t.busy_s == pytest.approx(plain.busy_s) and t.kernels == plain.kernels
