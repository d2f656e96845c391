"""The warp kernel's share of its roofline in the eval calls (%)."""

from harness.readers import roofline


def read(run):
    return roofline(run, "eval", "warp")
