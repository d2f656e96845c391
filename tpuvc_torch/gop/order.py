"""Hierarchical GOP coding orders and whole-sequence schedules (the port's
copy of tpuvc.gop.order).

A GOP's dyadic order is exposed level by level (``frames_by_level``): frames
within one hierarchy level do not depend on each other, which is the
batching axis of level-batched coding. ``sequence_schedule`` gives a whole
sequence's coding order and frame types from (gop, n_frames) alone, so the
sequence coders never transmit it.
"""

from __future__ import annotations

from dataclasses import dataclass

#: GOP-8 dyadic coding order and reference pairs (LHBDC test harness).
GOP8_ORDER = [0, 8, 4, 2, 1, 3, 6, 5, 7]
GOP8_REFS = {4: (0, 8), 2: (0, 4), 1: (0, 2), 3: (2, 4),
             6: (4, 8), 5: (4, 6), 7: (6, 8)}
GOP8_LEVEL = {4: 1, 2: 2, 6: 2, 1: 3, 3: 3, 5: 3, 7: 3}

#: GOP-16 dyadic order (Flex-Rate / ICIP2023 order).
GOP16_ORDER = [0, 16, 8, 4, 12, 2, 6, 10, 14, 1, 3, 5, 7, 9, 11, 13, 15]
GOP16_REFS = {
    8: (0, 16), 4: (0, 8), 12: (8, 16), 2: (0, 4), 6: (4, 8),
    10: (8, 12), 14: (12, 16), 1: (0, 2), 3: (2, 4), 5: (4, 6),
    7: (6, 8), 9: (8, 10), 11: (10, 12), 13: (12, 14), 15: (14, 16),
}
GOP16_LEVEL = {
    8: 1, 4: 2, 12: 2, 2: 3, 6: 3, 10: 3, 14: 3,
    1: 4, 3: 4, 5: 4, 7: 4, 9: 4, 11: 4, 13: 4, 15: 4,
}


@dataclass(frozen=True)
class GopTable:
    """Coding schedule for one GOP of size ``gop``: I-frames at 0 and gop."""

    gop: int
    order: list[int]          # coding order incl. both I anchors
    refs: dict[int, tuple[int, int]]
    level: dict[int, int]     # hierarchy level per B-frame

    def frames_by_level(self) -> list[list[int]]:
        """B-frames grouped by hierarchy level (independent within a level)."""
        n_levels = max(self.level.values())
        return [
            [f for f, lv in self.level.items() if lv == level]
            for level in range(1, n_levels + 1)
        ]


def gop_coding_table(gop: int) -> GopTable:
    if gop == 8:
        return GopTable(8, GOP8_ORDER, GOP8_REFS, GOP8_LEVEL)
    if gop == 16:
        return GopTable(16, GOP16_ORDER, GOP16_REFS, GOP16_LEVEL)
    # General dyadic construction for power-of-two GOPs.
    if gop < 2 or gop & (gop - 1):
        raise ValueError(f"GOP size must be a power of two >= 2, got {gop}")
    order = [0, gop]
    refs: dict[int, tuple[int, int]] = {}
    level: dict[int, int] = {}
    spans = [(0, gop, 1)]
    while spans:
        a, b, lv = spans.pop(0)
        if b - a < 2:
            continue
        mid = (a + b) // 2
        order.append(mid)
        refs[mid] = (a, b)
        level[mid] = lv
        spans.append((a, mid, lv + 1))
        spans.append((mid, b, lv + 1))
    return GopTable(gop, order, refs, level)


def sequence_order_from_table(gop: int, frame_number: int):
    """Sequence coding order built by tiling a static GOP table: I every
    ``gop`` frames, dyadic B order inside each GOP, a trailing partial GOP
    coded I-then-sequential.

    Returns (order list, type list) like get_order_typ_list.
    """
    table = gop_coding_table(gop)
    typ = ["B"] * frame_number
    order: list[int] = []
    seen = set()
    for start in range(0, frame_number - 1, gop):
        end = start + gop
        if end >= frame_number:
            break
        for f in table.order:
            idx = start + f
            if idx not in seen:
                order.append(idx)
                seen.add(idx)
        typ[start] = "I"
        typ[end] = "I"
    # Trailing frames that never closed a GOP: force final I, then remaining
    # frames rely on nearest-reference selection.
    for idx in range(frame_number):
        if idx not in seen:
            order.append(idx)
            seen.add(idx)
    typ[0] = "I"
    typ[-1] = "I"
    return order, typ


def get_order_typ_list(intra_size: int, frame_number: int):
    """Sequence-level coding order + frame types.

    Includes:
      - the dyadic base order tiled across the sequence,
      - I-frames every ``intra_size`` plus a forced final I,
      - the tail rewrites for 300- and 600-frame sequences.
    """
    # The dyadic base order is GOP-16-specific; other GOPs use the static
    # tables via gop_coding_table.
    assert intra_size == 16, "get_order_typ_list assumes a 16-frame base order"
    order = [16, 8, 4, 12, 2, 14, 6, 10, 1, 15, 3, 13, 5, 11, 7, 9]
    o = [0]
    lll = len(order)
    ff = (frame_number - 1) % intra_size
    for i in range(frame_number - 1):
        o.append(order[i % lll] + (i // lll) * lll)
    if ff != 0:
        m = max(o[:-ff])
        o[-ff:] = [(m + ff - i) for i in range(ff)]

    typ = ["I" if i % intra_size == 0 else "B" for i in range(frame_number)]
    typ[-1] = "I"

    if frame_number == 300:
        o[-11:] = [299, 293, 290, 296, 289, 291, 292, 294, 295, 297, 298]
    if frame_number == 600:
        o[-7:] = [599, 595, 593, 597, 594, 596, 598]
    return o, typ


def sequence_schedule(gop: int, frame_number: int):
    """Header-derivable whole-sequence schedule for the V-sequence coder.

    GOP 16 uses the algorithmic dyadic order with its tail patches
    (get_order_typ_list); other GOP sizes tile the static dyadic tables
    (sequence_order_from_table). Both sides of the codec call this with
    the (gop, n_frames) pair from the VSequenceBitstream header, so the
    coding order is never transmitted.
    """
    if gop == 16:
        return get_order_typ_list(16, frame_number)
    return sequence_order_from_table(gop, frame_number)
