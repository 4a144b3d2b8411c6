"""The 95th percentile (linear between order statistics) of the wall time
of every solve in the window, from the solve's start to the synchronise
after it, in milliseconds."""

import statistics


def read(run):
    if run.per != "iter" or len(run.solve_s) < 2:
        return None
    return statistics.quantiles(run.solve_s, n=20, method="inclusive")[18] * 1e3
