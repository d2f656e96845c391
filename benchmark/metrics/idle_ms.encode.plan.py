"""Device-idle ms per frame of the encode calls that fell while some thread was
inside the program's conv plan spans (a plan window, or a wait for or at one)
(ms/frame)."""

from harness.spans import idle_ms


def read(run):
    return idle_ms(run, "encode", "plan")
