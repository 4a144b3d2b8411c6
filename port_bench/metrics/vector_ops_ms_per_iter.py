"""Device milliseconds of every compute kernel but the BP1 mass apply
(kernel G, ``mass_tiled_kernel``) in the traced CG solves, over their
iterations: CG's vector algebra."""

MATVEC = "mass_tiled_kernel"


def read(run):
    t = run.trace
    if run.per != "iter" or t is None or not any(MATVEC in n for n, _, _ in t.kernels):
        return None
    other_us = sum(b - a for n, a, b in t.kernels if MATVEC not in n)
    return other_us * 1e-3 / t.units
