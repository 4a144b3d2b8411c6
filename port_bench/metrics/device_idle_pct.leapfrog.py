"""The share of the traced window (a few whole leapfrog solves) in which
no device activity runs, in percent (``trace.idle_pct``)."""

from port_bench import trace


def read(run):
    return trace.idle_pct(run, "step")
