"""The warp kernel's share of its roofline in the decode calls (%), in the FlowGuidedB cells: the quantity of
``warp_roofline.decode``, moving their own rate."""

from harness.readers import roofline


def read(run):
    return roofline(run, "decode", "warp")
