"""The trace reading on a synthetic event list: the busy time is the union
of device intervals, overlapping launches count once, the profiler's own
marks and the harness's span annotations are no kernels, and host syncs
count inside the solve spans only."""

from types import SimpleNamespace

import pytest
import torch

from port_bench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, a, b, dev=CPU):
    return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=a, end=b))


def test_summarize_a_synthetic_trace():
    events = [
        ev("ProfilerStep#2", 0, 1000), ev("ProfilerStep#2", 5, 900, CUDA),
        ev("port_bench.prep", 0, 10), ev("port_bench.solve", 10, 600),
        ev("port_bench.sync", 600, 1000), ev("port_bench.solve", 20, 590, CUDA),
        ev("kernel_a", 100, 300, CUDA), ev("kernel_b", 250, 400, CUDA),  # overlap 50
        ev("Memcpy DtoH", 450, 460, CUDA), ev("kernel_a", 700, 900, CUDA),
        ev("cudaStreamSynchronize", 440, 470), ev("cudaDeviceSynchronize", 610, 990),
        ev("aten::add", 410, 440), ev("cudaLaunchKernel", 90, 95),
    ]
    t = trace.summarize(events, units=2.0)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx((300 + 10 + 200) * 1e-6)
    assert [k[0] for k in t.kernels] == ["kernel_a", "kernel_b", "kernel_a"]
    assert t.host_syncs == 1 and t.saw_runtime
    assert t.by_name["kernel_a"] == pytest.approx(400e-6)
    gaps = t.breakdown()["idle_gaps"]
    assert [g[0] for g in gaps] == ["solve", "sync: cudaDeviceSynchronize", "solve",
                                    "solve: aten::add"]
    assert [g[1] for g in gaps] == pytest.approx([240e-6, 100e-6, 100e-6, 50e-6])
    assert sum(g[1] for g in gaps) == pytest.approx(t.window_s - t.busy_s)


def test_no_device_activity_gives_no_trace():
    assert trace.summarize([ev("port_bench.solve", 0, 10), ev("aten::add", 1, 2)], 1.0) is None
    assert trace.summarize([ev("kernel_a", 0, 10, CUDA)], 1.0) is None
