"""Device milliseconds of every compute kernel but kernel K's
(``wave_general::general_*``) in the traced solves, over their steps: the
eager RK4 stage algebra and ``WavePhysics.f1``'s source, damping and mass
terms. The union of their intervals, merged as the busy time is
(``trace.py``), so that this and ``stiffness_ms_per_step.mesh`` add up to
no more than the busy time."""

from port_bench import trace

K = "wave_general::general_"


def read(run):
    t = run.trace
    if run.per != "step" or t is None or not any(K in n for n, _, _ in t.kernels):
        return None
    merged = trace._merge((a, b) for n, a, b in t.kernels if K not in n)
    return sum(b - a for a, b in merged) * 1e-3 / t.units
