"""Device-idle ms per frame of the encode calls that fell inside the program's
intra or inter spans (dispatching a coding call's device work), outside
entropy and plan spans (ms/frame)."""

from harness.spans import idle_ms


def read(run):
    return idle_ms(run, "encode", "model")
