"""The idle split (``harness/spans.py``): device-idle stretches divided
among the program's spans by precedence, None where the program's clock
disagrees with the trace's; on the card, the program's spans add no device
operation to the trace."""

import types

import pytest
import torch

from harness import spans, trace
from tpuvc_torch import obs


class _Ev:
    """A stand-in for the profiler's event objects."""

    def __init__(self, name, start_s, dur_s, cpu=True):
        self._n, self._s, self._d, self._cpu = name, start_s, dur_s, cpu

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int(self._d * 1e9)

    def correlation_id(self):
        return 0

    def linked_correlation_id(self):
        return 0

    def is_user_annotation(self):
        return self._n.startswith(("bench.", "tpuvc."))

    def device_type(self):
        return torch.autograd.DeviceType.CPU if self._cpu else torch.autograd.DeviceType.CUDA


def _run(records, shift_s=0.0):
    """One encode call over [100, 110) s with device operations at [101, 102),
    [104, 105), [108, 109): idle [100, 101), [102, 104), [105, 108), [109, 110)."""
    ev = [_Ev("bench.encode", 100.0, 10.0)]
    ev += [_Ev("kernel", 100.0 + a, 1.0, cpu=False) for a in (1.0, 4.0, 8.0)]
    run = types.SimpleNamespace(trace=trace.Trace(ev),
                                parts={"traced": {"encode": {"frames": 10}}})
    shifted = [obs.Record(i, p, r, n, th, int((100 + a + shift_s) * 1e9),
                          int((100 + b + shift_s) * 1e9))
               for i, p, r, n, th, a, b in records]
    return run, shifted


# (id, parent, root, name, thread, start, end), times from the call's start
RECORDS = [
    (1, None, 1, "encode", 7, 0.0005, 9.9995),
    (2, 1, 1, "frames.upload", 7, 0.2, 0.5),       # cli 0.3 of [0, 1)
    (3, 1, 1, "entropy.wait", 7, 2.0, 3.5),        # entropy 1.0 of [2, 4) ...
    (4, 1, 1, "plan.wait", 8, 2.5, 3.0),           # ... and plan 0.5 over it
    (5, 1, 1, "inter", 7, 5.0, 7.0),               # model 1.5 of [5, 8) ...
    (6, 5, 1, "entropy.fetch", 7, 6.0, 6.5),       # ... entropy 0.5 inside it
    (7, 5, 1, "entropy.rans", 9, 7.0, 8.0),        # another thread: no cause
    (8, 1, 1, "container", 7, 9.2, 9.6),           # cli 0.4 of [9, 10)
]


def test_the_idle_stretches_split_by_precedence(monkeypatch):
    run, recs = _run(RECORDS)
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    got = spans.idle_split(run, "encode")
    want = {"plan": 0.5, "entropy": 1.5, "model": 1.5, "cli": 0.7, "unattributed": 2.8}
    assert got == pytest.approx(want, abs=1e-6)
    # the five add up to the idle time device_idle_pct reads
    assert sum(got.values()) == pytest.approx(run.trace.idle_share("encode") / 100 * 10.0)
    assert spans.idle_ms(run, "encode", "entropy") == pytest.approx(150.0)
    assert spans.idle_ms(run, "encode", "plan") == pytest.approx(50.0)
    assert spans.idle_split(run, "decode") is None  # no call of the phase


def test_no_split_on_a_disagreeing_clock_or_without_records(monkeypatch):
    run, recs = _run(RECORDS, shift_s=0.002)
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    assert spans.idle_split(run, "encode") is None
    run, recs = _run(RECORDS, shift_s=0.0009)  # within the slack
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    assert spans.idle_split(run, "encode") is not None
    monkeypatch.setattr(spans, "program_records", lambda: None)
    assert spans.idle_ms(types.SimpleNamespace(trace=run.trace, parts=run.parts),
                         "encode", "model") is None
    assert spans.idle_split(types.SimpleNamespace(trace=None), "encode") is None


@pytest.mark.gpu
def test_card_program_spans_add_no_device_operation(card):
    """The device-side copies of the program's ``tpuvc.*`` ranges are no
    device operations: N kernels inside N spans give a trace of N."""
    n = 12
    x = torch.randn(1 << 20, device=card)
    x.mul_(1.0001)
    torch.cuda.synchronize()
    obs.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.encode"):
            with obs.span("encode"):
                for i in range(n):
                    with obs.span("inter", level=i, batch=1):
                        x.mul_(1.0001)
                torch.cuda.synchronize()
    t = trace.Trace(prof.profiler.kineto_results.events())
    assert t.device_ops == n
    run = types.SimpleNamespace(trace=t, parts={"traced": {"encode": {"frames": 1}}})
    got = spans.idle_split(run, "encode")
    assert got is not None  # the program's clock agrees with the trace's
    lo, hi = t.calls("encode")[0]
    assert sum(got.values()) == pytest.approx(hi - lo - t.busy(lo, hi), rel=1e-6)
    obs.reset()
