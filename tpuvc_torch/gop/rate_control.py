"""Per-frame rate control tables (a copy of tpuvc.gop.rate_control).

- Flex-Rate: 8 RD points, each an intra quality and a (n, l) gain level per
  hierarchy level of the B-frames;
- LHBDC: one model per lambda, each paired with an intra quality.
"""

from __future__ import annotations

#: Flex-Rate RD points: (intra_q, {hierarchy_level: (n, l)}).
#: n indexes the 6-level gain matrix, l in (0, 1] interpolates toward n+1.
FLEXRATE_QUALITIES = [
    (5, {0: (1, 1.0), 1: (0, 0.33), 2: (0, 0.66), 3: (0, 1.0)}),
    (6, {0: (1, 0.66), 1: (1, 1.0), 2: (0, 0.33), 3: (0, 0.66)}),
    (6, {0: (1, 0.33), 1: (1, 0.66), 2: (1, 1.0), 3: (0, 0.33)}),
    (6, {0: (2, 1.0), 1: (1, 0.33), 2: (1, 0.66), 3: (1, 1.0)}),
    (7, {0: (2, 0.66), 1: (2, 1.0), 2: (1, 0.33), 3: (1, 0.66)}),
    (7, {0: (2, 0.33), 1: (2, 0.66), 2: (2, 1.0), 3: (1, 0.33)}),
    (7, {0: (3, 1.0), 1: (2, 0.33), 2: (2, 0.66), 3: (2, 1.0)}),
    (8, {0: (3, 1.0), 1: (3, 1.0), 2: (3, 1.0), 3: (2, 0.33)}),
]

#: LHBDC: (intra quality, lambda) per RD point.
LHBDC_POINTS = [
    (4, 228),
    (5, 436),
    (6, 845),
    (7, 1626),
    (8, 3141),
]


def flexrate_rate_for_frame(point: int, hier_level: int) -> tuple[int, float]:
    """(n, l) for a B-frame at ``hier_level`` under RD point ``point``.

    Hierarchy levels deeper than the table (level 4 in GOP-16) reuse the
    deepest entry.
    """
    _, table = FLEXRATE_QUALITIES[point]
    return table[min(hier_level - 1, max(table))]
