"""The warp kernel's share of its roofline in the decode calls (%)."""

from harness.readers import roofline


def read(run):
    return roofline(run, "decode", "warp")
