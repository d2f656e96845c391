"""What the per-layer readers (``benchmark/metrics/<metric>.py``) share.
Each returns None where its run has nothing to read: no trace, no call of
the phase, no device time of the kernel."""

from __future__ import annotations

from . import work


def idle_pct(run, phase: str):
    """The share of the phase's calls' wall time in which no device
    operation ran: the union of the operations' intervals, so overlapping
    kernels count once."""
    if run.trace is None:
        return None
    return run.trace.idle_share(phase)


def mfu(run, phase: str):
    """The phase's FLOPs (counted on the reference at the cell's shapes)
    over the wall time of its calls that ran without the profiler, against
    the bf16 peak."""
    p = run.parts.get("quiet", {}).get(phase)
    if not p or p["seconds"] <= 0 or phase not in run.work:
        return None
    flops = run.work[phase]["flops"] * p["sequences"]
    return 100.0 * flops / p["seconds"] / work.PEAK_BF16_FLOPS


def roofline(run, phase: str, kernel: str):
    """The least time of the phase's ``kernel`` calls at the chip's peaks
    over the device time of the operations launched inside its spans."""
    if run.trace is None or phase not in run.work:
        return None
    spent = run.trace.device_time(kernel, run.trace.calls(phase))
    least = run.work[phase][f"{kernel}_s"] * run.sequences(phase, "traced")
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent


def entropy_wait_ms(run, phase: str = "encode"):
    """Host ms per B-frame blocked in the coder's resolve() closures."""
    if run.entropy is None or run.entropy.calls == 0:
        return None
    mix = run.cell.mix
    gop, n = mix["gop"], mix["frames"]
    n_use = ((n - 1) // gop) * gop + 1
    b_frames = (n_use - ((n_use - 1) // gop + 1)) * run.sequences(phase)
    return 1000.0 * run.entropy.seconds / b_frames if b_frames else None
