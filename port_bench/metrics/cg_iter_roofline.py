"""A CG iteration's least time at the card's peaks (``roofline.py``) over
the device's busy time a traced iteration, in percent."""

from port_bench import roofline


def read(run):
    return roofline.share_pct(run, "iter")
