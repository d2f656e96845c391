"""Share of the encode calls' wall time in which no device operation ran (%)."""

from harness.readers import idle_pct


def read(run):
    return idle_pct(run, "encode")
