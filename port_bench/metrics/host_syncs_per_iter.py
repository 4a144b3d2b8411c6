"""Synchronising CUDA runtime calls (``trace.SYNC_CALLS``) the host made
inside the traced CG solves, over their iterations; None where the trace
holds no runtime calls at all."""


def read(run):
    t = run.trace
    if run.per != "iter" or t is None or not t.saw_runtime:
        return None
    return t.host_syncs / t.units
