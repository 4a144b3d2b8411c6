"""Seconds of the port's model or operator construction, synchronised
(``planar3d_app.build``; ``bp1_setup``)."""


def read(run):
    return run.build_s
