"""Dofs x steps of every leapfrog solve completed in the window over the
whole window, in 1e9 a second. A metric apart from the RK4 cell's: the
host paces this path, and its runs spread more."""


def read(run):
    if run.per != "step":
        return None
    return run.ndofs * sum(run.units) / run.window_s / 1e9
