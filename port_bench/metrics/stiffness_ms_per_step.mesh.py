"""Device milliseconds of kernel K (``wave_general::general_*``: the zero
launch and one a colour) in the traced solves, over their steps: the union
of its launches' intervals, merged as the busy time is (``trace.py``), since
programmatic dependent launch lets a colour's launch start before the one
before it ends."""

from port_bench import trace

K = "wave_general::general_"


def read(run):
    t = run.trace
    if run.per != "step" or t is None or not any(K in n for n, _, _ in t.kernels):
        return None
    merged = trace._merge((a, b) for n, a, b in t.kernels if K in n)
    return sum(b - a for a, b in merged) * 1e-3 / t.units
