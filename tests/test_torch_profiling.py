"""The port's spans (``utils/profiling.py``): ``annotate`` is a shared no-op
without a recording profiler and a named host range under one; CG and the
box's step paths open one span per unit of work and compute the same
answers with and without the profiler, as does a general mesh's RK4
solve (``wave.rk4_eager.step``); the readings of a trace
(``host_span_us``, ``device_busy_us``) on hand-made events."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_cases import random_padded, torch_model
from wave_fenics_tpu_torch.benchmarks.general_solve import perturbed_box
from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.solvers.cg import cg
from wave_fenics_tpu_torch.utils import profiling
from wave_fenics_tpu_torch.utils.profiling import BLOCKED, annotate

F64 = torch.float64
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _traced(fn):
    """fn's result and the (name, start, end) of each host span ``wave.*``
    that it opened under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name.startswith("wave.") and e.device_type == CPU]


def _count(spans, name):
    return sum(1 for n, _, _ in spans if n == name)


def test_annotate_without_a_profiler_makes_no_torch_call(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler call with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first = annotate("wave.test")
    assert annotate("wave.other") is first
    with first:
        torch.ones(3).add_(1.0)


def test_annotate_is_a_named_host_range_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("wave.test"):
            torch.ones(3).add_(1.0)
    (span,) = [e for e in prof.events() if e.name == "wave.test"]
    assert span.device_type == CPU
    (add,) = [e for e in prof.events() if e.name == "aten::add_"]
    assert span.time_range.start <= add.time_range.start
    assert add.time_range.end <= span.time_range.end


def _spd(n=12, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n))
    a = torch.as_tensor(q @ q.T + n * np.eye(n), dtype=F64)
    return a, torch.as_tensor(rng.standard_normal(n), dtype=F64)


@pytest.mark.parametrize("kmax,rtol", [(5, 1e-30), (50, 1e-6)])
def test_cg_spans_and_answers(kmax, rtol):
    """One stopping test and one iteration span per iteration, nested in the
    solve's span; a test that stops the loop early is an iteration span of
    its own that holds only that test. x, k and rnorm are bitwise the same
    with the profiler and without."""
    a, b = _spd()

    def solve():
        return cg(lambda v: a @ v, b, kmax=kmax, rtol=rtol)

    x0, k0, r0 = solve()
    (x, k, r), spans = _traced(solve)
    assert torch.equal(x, x0) and k == k0 and torch.equal(r, r0)
    early = k < kmax
    assert early == (kmax == 50)
    assert _count(spans, "wave.cg.iter") == k + early
    assert _count(spans, "wave.cg.stop_test") == k + early
    assert _count(spans, "wave.cg.matvec") == k
    ((_, s0, s1),) = [s for s in spans if s[0] == "wave.cg.solve"]
    iters = sorted((a0, a1) for n, a0, a1 in spans if n == "wave.cg.iter")
    assert all(s0 <= a0 and a1 <= s1 for a0, a1 in iters)
    for n, t0, t1 in spans:
        if n in ("wave.cg.stop_test", "wave.cg.matvec"):
            assert sum(a0 <= t0 and t1 <= a1 for a0, a1 in iters) == 1
    last0, last1 = iters[-1]
    inside = [n for n, t0, t1 in sorted(spans, key=lambda s: s[1])
              if last0 <= t0 and t1 <= last1 and n != "wave.cg.iter"]
    assert inside == ["wave.cg.stop_test"] + ([] if early else ["wave.cg.matvec"])


@pytest.fixture(scope="module")
def box():
    pm = PaddedLinearWave(torch_model(p=2), tile_x=16)
    assert pm.step_unavailable is None and pm.lf2_unavailable is None
    u0 = torch.as_tensor(random_padded(pm.layout, 0))
    v0 = torch.as_tensor(random_padded(pm.layout, 1))
    return pm, u0, v0


@pytest.mark.parametrize("nsteps", [3, 4])
def test_rk4_step_spans(box, nsteps):
    pm, u0, v0 = box
    dt = 1e-9
    want = pm.solve_step_n(0.0, dt, nsteps, u0, v0)
    got, spans = _traced(lambda: pm.solve_step_n(0.0, dt, nsteps, u0, v0))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _count(spans, "wave.rk4.solve") == 1
    assert _count(spans, "wave.rk4.step") == nsteps


@pytest.mark.parametrize("nsteps", [3, 4])
def test_lf2_call_spans(box, nsteps):
    pm, u0, v0 = box
    dt = 0.5e-9
    want = pm.solve_lf2_n(0.0, dt, nsteps, u0, v0)
    got, spans = _traced(lambda: pm.solve_lf2_n(0.0, dt, nsteps, u0, v0))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _count(spans, "wave.lf2.solve") == 1
    assert _count(spans, "wave.lf.step") == nsteps % 2
    assert 2 * _count(spans, "wave.lf2.call") + _count(spans, "wave.lf.step") == nsteps


@pytest.fixture(scope="module")
def general():
    hm, tags = perturbed_box((3, 2, 2), h=0.025, seed=1)
    model = GeneralLinearWave(hm, 2, tags, dtype=F64, device="cpu")
    g = torch.Generator().manual_seed(6)
    u0, v0 = (torch.randn(model.ndofs, dtype=F64, generator=g) for _ in range(2))
    return model, u0, v0


@pytest.mark.parametrize("nsteps", [2, 3])
def test_general_rk4_spans(general, nsteps):
    """A general mesh's RK4 solve: one ``wave.rk4_eager.step`` a step, one
    after another, and no other span of the port; the same answer bit for
    bit with the profiler and without."""
    model, u0, v0 = general
    dt = 2e-8
    want = model.solve_n(0.0, dt, nsteps, u0, v0)
    got, spans = _traced(lambda: model.solve_n(0.0, dt, nsteps, u0, v0))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert [n for n, _, _ in spans] == ["wave.rk4_eager.step"] * nsteps
    steps = sorted((a, b) for _, a, b in spans)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(steps, steps[1:]))


def test_general_solve_records_no_span_without_a_profiler(general, monkeypatch):
    """Without a recording profiler the general solve makes no profiler
    call, and its answer is the profiled one's bit for bit."""
    model, u0, v0 = general
    profiled, spans = _traced(lambda: model.solve_n(0.0, 2e-8, 2, u0, v0))
    assert _count(spans, "wave.rk4_eager.step") == 2

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler call with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    u, v = model.solve_n(0.0, 2e-8, 2, u0, v0)
    assert torch.equal(u, profiled[0]) and torch.equal(v, profiled[1])


def ev(name, a, b, dev=CPU):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=a, end=b))


def test_host_span_us_less_the_covered_part():
    events = [
        ev("wave.rk4.step", 0, 100), ev("wave.rk4.step", 100, 400),
        ev("wave.rk4.step", 400, 450),
        ev(BLOCKED, 150, 250), ev(BLOCKED, 200, 300), ev(BLOCKED, 380, 420),
        ev(BLOCKED, 600, 700), ev("wave.rk4.step", 0, 1000, CUDA),
        ev("cudaLaunchKernel", 10, 20),
    ]
    assert profiling.host_span_us(events, ("wave.rk4.step",)) == (3, 450)
    # 150-300 and 380-400 of the second span, 400-420 of the third
    assert profiling.host_span_us(events, ("wave.rk4.step",), (BLOCKED,)) == (
        3, 100 + (300 - 150 - 20) + (50 - 20))
    assert profiling.host_span_us(events, ("wave.cg.iter",)) == (0, 0)


def test_device_busy_us_is_the_union_of_device_intervals():
    events = [ev("k_a", 100, 300, CUDA), ev("k_b", 250, 400, CUDA),  # overlap 50
              ev("Memcpy DtoH", 450, 460, CUDA), ev("k_a", 700, 900, CUDA),
              ev("aten::add", 0, 1000)]
    assert profiling.device_busy_us(events) == 300 + 10 + 200
    assert profiling.device_busy_us([ev("aten::add", 0, 10)]) == 0
