"""Host ms per B-frame that the encoder spends blocked on the host
entropy coder's results (ms/frame), in the FlowGuidedB cells: the quantity of
``entropy_wait_ms.encode``, moving their own rate."""

from harness.readers import entropy_wait_ms


def read(run):
    return entropy_wait_ms(run, "encode")
