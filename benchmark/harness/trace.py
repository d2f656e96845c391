"""Spans, the profiler's device trace, and their reduction.

Spans are ``torch.profiler.record_function`` ranges named ``bench.<name>``
that the harness opens around calls into the program's layers (installed
only in a traced run, from the benchmark's own files):

- ``bench.<phase>`` around each timed call (encode, decode, eval);
- ``bench.warp`` around ``tpuvc_torch.ops.warp.warp`` and ``warp_and_blend``,
  ``bench.deform`` around ``tpuvc_torch.ops.deform.deform_conv2d``: every
  module attribute under ``tpuvc_torch`` that *is* one of those functions is
  wrapped, so bound names (``from ... import warp``) are covered, whatever
  kernel the function launches;
- ``bench.entropy_wait`` around the ``resolve()`` closures of the coder's
  ``encode_level_batch_async`` (the harness wraps the coder instance).

The device trace gives each kernel, copy and set's interval; a device
operation belongs to the span its launch (the host-side runtime call of the
same correlation id) lies in.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import time

import numpy as np
import torch

#: kernel families of the breakdown, first match wins (the spans' warp and
#: deform come first, by span and not by name).
FAMILIES = [
    ("layout", ("nchwToNhwc", "nhwcToNchw", "permute")),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop", "fft",
              "region_transform", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
    ("copy", ("memcpy", "memset", "copy", "cat")),
]


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "elementwise"


def _wrap(fn, span: str):
    def spanned(*a, **k):
        with torch.profiler.record_function(f"bench.{span}"):
            return fn(*a, **k)

    spanned.__wrapped__ = fn
    return spanned


@contextlib.contextmanager
def kernel_spans():
    """Wrap the warp and deform entry points wherever the program binds
    them, for the enclosed code."""
    from tpuvc_torch.ops import deform, warp

    targets = {id(warp.warp): "warp", id(deform.deform_conv2d): "deform"}
    if hasattr(warp, "warp_and_blend"):
        targets[id(warp.warp_and_blend)] = "warp"
    patched = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == "tpuvc_torch" or name.startswith("tpuvc_torch.")):
            continue
        for attr, val in list(vars(mod).items()):
            span = targets.get(id(val))
            if span is not None and callable(val):
                setattr(mod, attr, _wrap(val, span))
                patched.append((mod, attr, val))
    try:
        yield
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


class EntropyWait:
    """Host seconds spent blocked in the coder's ``resolve()`` closures,
    from a wrapper on the coder instance."""

    def __init__(self, coder):
        self.seconds = 0.0
        self.calls = 0
        self.coder = coder
        inner = coder.encode_level_batch_async

        def encode_level_batch_async(*a, **k):
            resolve, x_hat = inner(*a, **k)

            def timed():
                t0 = time.perf_counter()
                with torch.profiler.record_function("bench.entropy_wait"):
                    out = resolve()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out

            return timed, x_hat

        coder.encode_level_batch_async = encode_level_batch_async

    def close(self):
        del self.coder.encode_level_batch_async


def union_length(starts, ends) -> float:
    """Total length covered by the intervals [starts[i], ends[i]) (any
    order, any overlap)."""
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, e = np.asarray(starts, float)[order], np.asarray(ends, float)[order]
    reach = np.maximum.accumulate(e)
    # a new run starts where an interval begins after everything before ends
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    run_start = s[new]
    run_end = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    return float(np.sum(run_end - run_start))


def gaps(starts, ends, lo: float, hi: float) -> list:
    """The [start, end) stretches of [lo, hi) that no interval covers."""
    s = np.clip(np.asarray(starts, float), lo, hi)
    e = np.clip(np.asarray(ends, float), lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    out, t = [], lo
    if len(s):
        reach = np.maximum.accumulate(e)
        prev = np.concatenate([[lo], reach[:-1]])
        idx = np.flatnonzero(s > np.maximum(prev, lo))
        out = [(float(max(prev[i], lo)), float(s[i])) for i in idx]
        t = float(reach[-1])
    if t < hi:
        out.append((t, hi))
    return out


def _call(e, name: str, default=None):
    f = getattr(e, name, None)
    return default if f is None else f()


def _times(e) -> tuple[float, float]:
    """(start, end) in seconds on the trace's axis."""
    if hasattr(e, "start_ns"):
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
    else:
        s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
    return s, s + d


class Trace:
    """The reduction of one profiled window: device operations (seconds,
    on the host clock's axis) with their family, and the harness's spans.
    A device operation belongs to a warp or deform span if the host-side
    API call that launched it (same correlation id) lies in the span."""

    def __init__(self, events):
        cpu = torch.autograd.DeviceType.CPU
        spans, runtime, device = [], {}, []
        for e in events:
            name = e.name()
            on_host = e.device_type() == cpu
            s, t = _times(e)
            if name.startswith("bench."):
                if on_host:  # the device-side copy of a span is no operation
                    spans.append((s, t, name[6:]))
            elif not on_host:
                if not _call(e, "is_user_annotation", False):
                    device.append((s, t, name, _call(e, "correlation_id", 0),
                                   _call(e, "linked_correlation_id", 0)))
            elif name.startswith("cu"):  # cuda*/cu* API calls: launches, copies
                runtime[_call(e, "correlation_id", 0)] = s
        self.spans = sorted(spans)
        by_corr = sum(1 for d in device if d[3] in runtime)
        by_linked = sum(1 for d in device if d[4] in runtime)
        key = 3 if by_corr >= by_linked else 4
        kernel_spans = [(a, b, n) for a, b, n in self.spans if n in ("warp", "deform")]
        starts = [a for a, _, _ in kernel_spans]
        self.ops = []  # (start, end, family)
        for d in device:
            fam = family(d[2])
            launch = runtime.get(d[key])
            if launch is not None:
                i = bisect.bisect_right(starts, launch) - 1
                if i >= 0 and kernel_spans[i][0] <= launch <= kernel_spans[i][1]:
                    fam = kernel_spans[i][2]
            self.ops.append((d[0], d[1], fam))
        self.op_start = np.array([o[0] for o in self.ops], float)
        self.op_end = np.array([o[1] for o in self.ops], float)
        self.op_fam = np.array([o[2] for o in self.ops], dtype=object)
        self.launches_matched = max(by_corr, by_linked)
        self.device_ops = len(device)

    def calls(self, phase: str) -> list:
        return [(s, e) for s, e, n in self.spans if n == phase]

    def _in(self, lo: float, hi: float, fam: str | None = None):
        sel = (self.op_end > lo) & (self.op_start < hi)
        if fam is not None:
            sel &= self.op_fam == fam
        return np.clip(self.op_start[sel], lo, hi), np.clip(self.op_end[sel], lo, hi), sel

    def busy(self, lo: float, hi: float, fam: str | None = None) -> float:
        s, e, _ = self._in(lo, hi, fam)
        return union_length(s, e)

    def device_time(self, fam: str, windows) -> float:
        """Summed device time of ``fam``'s operations inside ``windows``."""
        return float(sum(np.sum(e - s) for s, e, _ in
                         (self._in(lo, hi, fam) for lo, hi in windows)))

    def idle_share(self, phase: str) -> float | None:
        calls = self.calls(phase)
        wall = sum(e - s for s, e in calls)
        if not calls or wall <= 0:
            return None
        return 100.0 * (wall - sum(self.busy(s, e) for s, e in calls)) / wall

    def label(self, t: float) -> str:
        """The harness spans open at host time ``t``, outermost first."""
        open_ = [(s, n) for s, e, n in self.spans if s <= t < e]
        return "/".join(n for _, n in sorted(open_)) or "outside"

    def breakdown(self, windows, top: int = 10) -> dict:
        """The device operations' families with the most time, and the
        longest idle gaps labelled by the spans the host was in, inside
        ``windows`` (the timed calls)."""
        fams: dict = {}
        idle = []
        for lo, hi in windows:
            s, e, sel = self._in(lo, hi)
            for f, d in zip(self.op_fam[sel], e - s):
                fams[f] = fams.get(f, 0.0) + float(d)
            idle += gaps(s, e, lo, hi)
        ops = sorted(fams.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(idle, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[f, t] for f, t in ops],
                "idle_gaps": [[self.label((a + b) / 2), b - a] for a, b in idle]}
