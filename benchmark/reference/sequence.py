"""A sequence coded as the hierarchical-B codecs code it, in plain terms:
an intra-coded anchor every ``gop`` frames, and between two anchors the
frames coded by bisection, each B-frame from the two nearest frames already
coded. One frame at a time; every reconstruction clamped to [0, 1] before
it serves as a reference."""

from __future__ import annotations

import torch


def bisection(gop: int) -> list[tuple[int, int, int]]:
    """[(frame, ref before, ref after)] of one GOP in coding order."""
    out, spans = [], [(0, gop)]
    while spans:
        nxt = []
        for a, b in spans:
            if b - a > 1:
                m = (a + b) // 2
                out.append((m, a, b))
                nxt += [(a, m), (m, b)]
        spans = nxt
    return out


def code(frames, n: int, gop: int, intra, inter, outputs: dict | None = None) -> dict:
    """{display index: clamped reconstruction (1, H, W, 3)} of the largest
    k*gop + 1 prefix of ``n`` frames. ``frames(i)`` gives frame i on the
    device; ``intra(x)`` and ``inter(ref_before, x, ref_after, order, o1,
    o2)`` return the reconstruction first; ``outputs`` (if given) receives
    each frame's whole return value."""
    n_use = ((n - 1) // gop) * gop + 1
    rec = {}

    def keep(i, out):
        if outputs is not None:
            outputs[i] = out
        rec[i] = torch.clamp(out[0], 0.0, 1.0)

    for g in range(0, n_use - 1, gop):
        for a in (g, g + gop):
            if a not in rec:
                keep(a, intra(frames(a)))
        for f, a, b in bisection(gop):
            keep(g + f, inter(rec[g + a], frames(g + f), rec[g + b], f, a, b))
    return rec
