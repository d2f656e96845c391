"""The encode calls' model FLOPs over the wall time of those that ran without
the profiler, against the bf16 peak (%), in the FlowGuidedB cells: the quantity of
``mfu.encode``, moving their own rate."""

from harness.readers import mfu


def read(run):
    return mfu(run, "encode")
