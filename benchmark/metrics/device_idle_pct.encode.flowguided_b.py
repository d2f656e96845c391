"""Share of the encode calls' wall time in which no device operation ran (%), in the FlowGuidedB cells: the quantity of
``device_idle_pct.encode``, moving their own rate."""

from harness.readers import idle_pct


def read(run):
    return idle_pct(run, "encode")
