"""Dofs x steps of every RK4 solve completed in the window over the whole
window, in 1e9 a second."""


def read(run):
    if run.per != "step":
        return None
    return run.ndofs * sum(run.units) / run.window_s / 1e9
