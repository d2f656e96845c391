"""Device-idle ms per frame of the encode calls during which the innermost
program span open on the call's thread is a checkerboard parameter stage
(``stage.<coder>.group_params``, both CondELIC coders' entropy parameters a
group and phase) (ms/frame), in the DeformB cell. None where the program
named no such stage."""

import bisect

from harness import spans, trace


def _exposed(mine: list) -> list:
    """The stretches in which a ``group_params`` span is the innermost of
    ``mine`` (one thread's records, properly nested): each such span less
    the spans that open inside it."""
    mine = sorted(mine, key=lambda r: r[5])
    starts = [r[5] for r in mine]
    out = []
    for r in mine:
        name, t0, t1 = r[3], r[5], r[6]
        if not (name.startswith("stage.") and name.endswith(".group_params")):
            continue
        inner = mine[bisect.bisect_right(starts, t0):bisect.bisect_left(starts, t1)]
        _, rest = spans._take([(t0, t1)], spans._union((c[5], c[6]) for c in inner))
        out += rest
    return out


def read(run):
    if run.trace is None:
        return None
    raw = spans.program_records()
    calls = run.trace.calls("encode")
    frames = run.parts.get("traced", {}).get("encode", {}).get("frames", 0)
    if raw is None or not calls or not frames:
        return None
    records = [(r[0], r[1], r[2], r[3], r[4], r[5] * 1e-9, r[6] * 1e-9) for r in raw]
    roots = [r for r in records if r[3] == "encode" and r[1] is None]
    total, seen = 0.0, False
    for lo, hi in calls:
        root = next((r for r in roots if lo - spans.SLACK <= r[5] and r[6] <= hi + spans.SLACK),
                    None)
        if root is None:
            return None
        mine = [r for r in records if r[2] == root[0] and r[4] == root[4] and r[0] != root[0]]
        exposed = _exposed(mine)
        seen = seen or bool(exposed)
        sel = (run.trace.op_end > lo) & (run.trace.op_start < hi)
        stretches = trace.gaps(run.trace.op_start[sel], run.trace.op_end[sel], lo, hi)
        covered, _ = spans._take(stretches, spans._union(exposed))
        total += covered
    return 1000.0 * total / frames if seen else None
