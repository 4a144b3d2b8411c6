"""Dofs x CG iterations of every solve completed in the window over the
whole window, in 1e9 a second (the reference's Dofs*iteration/s,
demo/gpu_cg/utils.hpp:58-64)."""


def read(run):
    if run.per != "iter":
        return None
    return run.ndofs * sum(run.units) / run.window_s / 1e9
