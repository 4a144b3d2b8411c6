"""A leapfrog step's least time at the card's peaks (``roofline.py``) over
the device's busy time a traced step, in percent: kernel I's phases."""

from port_bench import roofline


def read(run):
    return roofline.share_pct(run, "step")
