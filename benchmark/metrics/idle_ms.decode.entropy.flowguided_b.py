"""Device-idle ms per frame of the decode calls that fell inside the program's
entropy spans (symbol fetches and uploads, rANS, waits on the coders' workers)
on the call's thread (ms/frame), in the FlowGuidedB cells."""

from harness.spans import idle_ms


def read(run):
    return idle_ms(run, "decode", "entropy")
