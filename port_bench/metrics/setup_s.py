"""Set-up seconds: from the run's first line to the window's start (the
torch import, the kernels built or loaded, the inputs, the port's model,
one warm-up solve)."""


def read(run):
    return run.setup_s
