"""The eval calls' model FLOPs over the wall time of those that ran without
the profiler, against the bf16 peak (%)."""

from harness.readers import mfu


def read(run):
    return mfu(run, "eval")
