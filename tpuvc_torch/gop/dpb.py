"""Decoded picture buffer with nearest-reference selection (the port's copy
of tpuvc.gop.dpb).

- keeps at most ``capacity`` (=32) decoded frames, FIFO eviction;
- selects the two decoded frames nearest in display order (ties toward the
  earlier-buffered frame, a stable sort), returned as (past_ref,
  future_ref) by display order.
"""

from __future__ import annotations

import numpy as np


class DecodedPictureBuffer:
    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self.frames: list = []
        self.orders: list[int] = []

    def __len__(self) -> int:
        return len(self.frames)

    def add(self, frame, order: int) -> None:
        self.frames.append(frame)
        self.orders.append(order)
        if len(self.frames) > self.capacity:
            self.frames.pop(0)
            self.orders.pop(0)

    def reset(self) -> None:
        self.frames.clear()
        self.orders.clear()

    def select_references(self, order: int):
        """-> (ref1, ref2, order1, order2), ref1 earlier in display order."""
        assert self.frames, "empty DPB"
        if len(self.frames) == 1:
            return self.frames[0], self.frames[0], self.orders[0], self.orders[0]
        d = np.abs(np.asarray(self.orders) - order)
        ind = np.argsort(d, kind="stable")[:2]
        a, b = int(ind[0]), int(ind[1])
        # Quirk kept from the codec this schedule comes from: with exactly
        # two candidates, min/max default to (ind[1], ind[0]) and swap only
        # if the buffered order of ind[0] is below that of ind[1].
        if self.orders[a] < self.orders[b]:
            lo, hi = a, b
        else:
            lo, hi = b, a
        return self.frames[lo], self.frames[hi], self.orders[lo], self.orders[hi]
