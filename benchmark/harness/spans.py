"""The device-idle time of each timed call, put down to what the program's
own spans (``tpuvc_torch.obs``) say the host was doing.

The idle stretches are the gaps in the union of the call's device
operations, the ones ``device_idle_pct`` sums (:func:`harness.trace.gaps`
over ``run.trace``). The program records its spans while the profiler
records, so a traced run's second half has both. Each stretch is divided
among the program's records open over it, in this order of precedence:

1. ``plan``: any thread is inside ``tpuvc.plan.*`` (a conv plan window, or
   a wait for or at one);
2. ``entropy``: the call's thread is inside ``tpuvc.entropy.*`` (symbol
   fetches and uploads, rANS, waits on the coders' workers);
3. ``model``: the call's thread is inside ``tpuvc.intra`` or
   ``tpuvc.inter`` (dispatching a coding call's device work);
4. ``cli``: the call's thread is inside any other span of the call;
5. ``unattributed``: none of these.

A call's thread and spans are those of its root, the program's
``tpuvc.<phase>`` record that lies inside the harness's ``bench.<phase>``
span.
"""

from __future__ import annotations

import bisect

from . import trace

CAUSES = ("plan", "entropy", "model", "cli", "unattributed")
#: how far a root record may stick out of its ``bench.<phase>`` call, s
SLACK = 1e-3


def program_records():
    """The program's span records, or None where the program has no
    ``tpuvc_torch.obs`` or recorded nothing."""
    try:
        from tpuvc_torch import obs
    except ImportError:
        return None
    return obs.records() or None


def _union(intervals) -> list:
    """Sorted disjoint [start, end) intervals covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _take(pieces, union) -> tuple[float, list]:
    """(length of ``pieces`` that ``union`` covers, the uncovered pieces)."""
    starts = [u[0] for u in union]
    covered, rest = 0.0, []
    for a, b in pieces:
        t = a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(union) and union[i][0] < b:
            lo, hi = max(union[i][0], t), min(union[i][1], b)
            if hi > lo:
                if lo > t:
                    rest.append((t, lo))
                covered += hi - lo
                t = hi
            i += 1
        if t < b:
            rest.append((t, b))
    return covered, rest


def split(stretches, records, root) -> dict:
    """{cause: seconds} of the idle ``stretches`` of one call whose root
    record is ``root`` (None: only ``plan`` can be told), from the
    program's ``records`` (seconds on the trace's axis)."""
    by = {c: [] for c in CAUSES[:4]}
    for rid, _, rroot, name, thread, t0, t1 in records:
        if name.startswith("plan."):
            by["plan"].append((t0, t1))
        elif root is None or thread != root[4] or rid == root[0]:
            continue
        elif name.startswith("entropy."):
            by["entropy"].append((t0, t1))
        elif name in ("intra", "inter"):
            by["model"].append((t0, t1))
        elif rroot == root[0]:
            by["cli"].append((t0, t1))
    out, rest = {}, list(stretches)
    for cause in CAUSES[:4]:
        out[cause], rest = _take(rest, _union(by[cause]))
    out["unattributed"] = sum(b - a for a, b in rest)
    return out


def idle_split(run, phase: str) -> dict | None:
    """{cause: device-idle seconds} summed over the phase's traced calls;
    None without a trace or the program's records, or where the clocks
    disagree: some ``tpuvc.<phase>`` record lies outside every
    ``bench.<phase>`` call by more than :data:`SLACK` at an end."""
    if run.trace is None:
        return None
    raw = program_records()
    calls = run.trace.calls(phase)
    if raw is None or not calls:
        return None
    records = [(r[0], r[1], r[2], r[3], r[4], r[5] * 1e-9, r[6] * 1e-9) for r in raw]
    roots = [r for r in records if r[3] == phase and r[1] is None]
    placed = {}
    for r in roots:
        inside = [c for c in calls if c[0] - SLACK <= r[5] and r[6] <= c[1] + SLACK]
        if not inside:
            return None
        placed[inside[0]] = r
    total = dict.fromkeys(CAUSES, 0.0)
    for lo, hi in calls:
        sel = (run.trace.op_end > lo) & (run.trace.op_start < hi)
        stretches = trace.gaps(run.trace.op_start[sel], run.trace.op_end[sel], lo, hi)
        root = placed.get((lo, hi))
        near = [r for r in records if r[6] > lo and r[5] < hi]
        for cause, s in split(stretches, near, root).items():
            total[cause] += s
    return total


def idle_ms(run, phase: str, cause: str):
    """Device-idle ms per frame of the phase's traced calls that falls to
    ``cause``."""
    cache = vars(run).setdefault("_idle_split", {})
    if phase not in cache:
        cache[phase] = idle_split(run, phase)
    got = cache[phase]
    frames = run.parts.get("traced", {}).get(phase, {}).get("frames", 0)
    if got is None or not frames:
        return None
    return 1000.0 * got[cause] / frames
