"""Compute kernels launched in the traced RK4 solves over their steps (the
profiler's device trace; copies not counted)."""


def read(run):
    t = run.trace
    if run.per != "step" or t is None or not t.kernels:
        return None
    return len(t.kernels) / t.units
