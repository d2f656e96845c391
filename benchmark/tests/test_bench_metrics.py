"""The metric arithmetic: the idle union over overlapping kernels, the
gaps, the rates, the warp and deform byte and operation counts, the
per-layer readers."""

import types

import pytest
import torch

from harness import core, readers, trace, work


def test_union_counts_overlapping_intervals_once():
    starts = [0.0, 1.0, 1.5, 5.0, 5.0, 9.0]
    ends = [2.0, 1.2, 3.0, 6.0, 5.5, 9.5]
    assert trace.union_length(starts, ends) == pytest.approx(3.0 + 1.0 + 0.5)
    assert trace.union_length([], []) == 0.0
    # order does not matter
    assert trace.union_length(starts[::-1], ends[::-1]) == pytest.approx(4.5)


def test_gaps_are_the_uncovered_stretches():
    g = trace.gaps([1.0, 2.0, 6.0], [3.0, 4.0, 7.0], 0.0, 10.0)
    assert g == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    assert trace.gaps([], [], 2.0, 3.0) == [(2.0, 3.0)]


class _Ev:
    """A stand-in for the profiler's event objects."""

    def __init__(self, name, act, start_s, dur_s, corr=0, user=False, cpu=True):
        self._n, self._s, self._d, self._c, self._u, self._cpu = (
            name, start_s, dur_s, corr, user, cpu)

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int(self._d * 1e9)

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0

    def is_user_annotation(self):
        return self._u

    def device_type(self):
        return torch.autograd.DeviceType.CPU if self._cpu else torch.autograd.DeviceType.CUDA


def _trace():
    ev = [
        _Ev("bench.decode", "user_annotation", 0.0, 10.0, user=True),
        _Ev("bench.warp", "user_annotation", 1.0, 1.0, user=True),
        _Ev("cudaLaunchKernel", "cuda_runtime", 1.5, 0.01, corr=7),
        _Ev("cudaLaunchKernel", "cuda_runtime", 3.0, 0.01, corr=8),
        # the warp kernel (launched inside the span) and two overlapping convs
        _Ev("warp_bilinear_nhwc", "kernel", 2.0, 1.0, corr=7, cpu=False),
        _Ev("sm90_xmma_fprop_implicit_gemm", "kernel", 4.0, 2.0, corr=8, cpu=False),
        _Ev("cudnn_conv", "kernel", 5.0, 2.0, corr=9, cpu=False),
        _Ev("Memcpy DtoH", "gpu_memcpy", 8.0, 0.5, corr=10, cpu=False),
        # the span's device-side range is not a device operation
        _Ev("bench.warp", "gpu_user_annotation", 2.0, 1.0, user=True, cpu=False),
    ]
    return trace.Trace(ev)


def test_trace_idle_share_and_span_attribution():
    t = _trace()
    # busy: [2,3) + [4,7) + [8,8.5) = 4.5 of 10
    assert t.idle_share("decode") == pytest.approx(55.0)
    assert t.device_time("warp", t.calls("decode")) == pytest.approx(1.0)
    assert t.device_time("conv", t.calls("decode")) == pytest.approx(4.0)
    b = t.breakdown(t.calls("decode"))
    assert dict((f, s) for f, s in b["device_ops"]) == pytest.approx(
        {"conv": 4.0, "warp": 1.0, "copy": 0.5})
    # the longest gap, [0, 2), is labelled by the spans open at its middle
    assert b["idle_gaps"][0] == ["decode/warp", pytest.approx(2.0)]
    assert t.idle_share("encode") is None


def test_warp_and_deform_counts():
    # image, flow and output once, float32
    n_bytes, ops = work.warp_cost((2, 8, 16, 3), (2, 8, 16, 2))
    assert n_bytes == 4 * (2 * 8 * 16 * 3 * 2 + 2 * 8 * 16 * 2)
    assert ops == work.WARP_OPS_PER_ELEMENT * 2 * 8 * 16 * 3
    n_bytes, ops = work.deform_cost((1, 4, 4, 32), (16, 2, 3, 3), groups=16)
    x, off, masks, out = 4 * 4 * 32, 4 * 4 * 16 * 9 * 2, 4 * 4 * 16 * 9, 4 * 4 * 16
    assert n_bytes == 4 * (x + off + masks + out + 16 * 2 * 9 + 16)
    # per (pixel, group): 9 taps x (18 + 8*2 + 2*2*1 + 1), then the bias
    assert ops == 4 * 4 * 16 * (9 * (18 + 16 + 4 + 1) + 1)
    assert work.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 67e12) == pytest.approx(1.0)


def _run(**kw):
    mix = {"gop": 16, "frames": 33}
    cell = types.SimpleNamespace(mix=mix)
    run = types.SimpleNamespace(cell=cell, trace=None, entropy=None, phases={}, parts={},
                                work={},
                                sequences=lambda p, part=None: (
                                    run.phases if part is None else run.parts.get(part, {})
                                ).get(p, {}).get("sequences", 0))
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_rates_and_readers():
    phases = {"encode": {"frames": 66, "seconds": 6.0, "calls": 2, "sequences": 2}}
    quiet = {"encode": {"frames": 33, "seconds": 2.0, "calls": 1, "sequences": 1}}
    run = _run(phases=phases, parts={"quiet": quiet},
               work={"encode": {"flops": 989e12 * 0.3, "warp_s": 0.1, "deform_s": 0.0}})
    assert core._rate(run, "encode_fps") == pytest.approx(11.0)
    assert core._rate(run, "decode_fps") is None
    # mfu reads the calls timed without the profiler: one sequence of 0.3 s
    # at the bf16 peak in 2 s, 15%
    assert readers.mfu(run, "encode") == pytest.approx(15.0)
    assert readers.roofline(run, "encode", "warp") is None  # no trace
    assert readers.idle_pct(run, "encode") is None
    run.entropy = types.SimpleNamespace(seconds=0.6, calls=8)
    # 30 B-frames a sequence, 2 sequences
    assert readers.entropy_wait_ms(run) == pytest.approx(10.0)


def test_the_rerun_is_held_to_the_window_s_output():
    a = {0: torch.zeros(4, 6, 3), 16: torch.ones(4, 6, 3)}
    b = {0: torch.zeros(4, 6, 3), 16: torch.ones(4, 6, 3)}
    b[16][1, 2, 0] = 0.5
    assert core._differ(core._digest(a), core._digest(a)) == 0
    assert core._differ(core._digest(b), core._digest(a)) == 1
    assert core._differ(core._digest({0: a[0]}), core._digest(a)) == 1  # a frame missing
    psnr = ([30.5, 31.25], [1200.0, 800.0])
    assert core._differ(core._digest(psnr), core._digest(psnr)) == 0
    assert core._differ(core._digest(([30.5, 31.0], [1200.0, 800.0])), core._digest(psnr)) == 1


def test_gaps_between_outputs():
    from harness import compare

    a = torch.ones(4, 3)
    assert compare.gap_pct(a, a) == 0.0
    assert compare.gap_pct(1.01 * a, a) == pytest.approx(1.0)
    # a reference output of zeros: only zeros pass
    assert compare.gap_pct(torch.zeros(3), torch.zeros(3)) == 0.0
    assert compare.gap_pct(torch.full((3,), 1e-6), torch.zeros(3)) == float("inf")
    # outputs that differ in number or in shape
    assert compare.gap_pct((a, a), (a,)) == float("inf")
    assert compare.gap_pct(a, torch.ones(3, 4)) == float("inf")
    assert compare.gap_pct(torch.tensor(float("nan")), torch.tensor(1.0)) == float("inf")


@pytest.mark.gpu
def test_card_trace_puts_the_warp_kernel_in_its_span(card):
    """On the card: a warp launched through the program's bound name lands
    in the warp span, and the conv beside it does not."""
    from tpuvc_torch.models import spynet
    from tpuvc_torch.ops import warp as W

    img = torch.rand((2, 272, 480, 3), device=card)
    flow = 3.0 * torch.randn((2, 272, 480, 2), device=card)
    conv = torch.nn.Conv2d(16, 16, 3, padding=1).to(card)
    x = torch.randn((2, 16, 256, 256), device=card)
    W.warp(img, flow, "lhbdc")
    conv(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with trace.kernel_spans(), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.decode"):
            conv(x)
            spynet.warp(img, flow, compat="lhbdc")  # the bound name SPyNet calls
            torch.cuda.synchronize()
    t = trace.Trace(prof.profiler.kineto_results.events())
    calls = t.calls("decode")
    assert t.device_time("warp", calls) > 0
    assert t.device_time("conv", calls) > 0
    assert 0.0 <= t.idle_share("decode") < 100.0
    assert spynet.warp is W.warp  # the spans are gone again
