"""tpuvc_torch on a CUDA card: the hand-written warp and deform kernels
against their plain PyTorch versions, and small runs of the LHBDC,
FlowGuidedB, DeformB, Flex-Rate and DMC paths on the card against the same
runs on the CPU and through their own decoders.

Marked ``gpu``; each test skips without a card. The card's machine has no
JAX, so this file imports none and runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuvc_torch.ops.precision import set_deterministic

    set_deterministic()
    return torch.device("cuda")


def _inputs(shape, scale=4.0, seed=0):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    img = rng.random(shape, dtype=np.float32)
    flow = (scale * rng.standard_normal((B, H, W, 2))).astype(np.float32)
    return torch.from_numpy(img), torch.from_numpy(flow)


@pytest.mark.parametrize("compat", ["exact", "lhbdc", "flexrate"])
@pytest.mark.parametrize("shape", [(2, 64, 128, 3), (1, 37, 53, 48), (3, 34, 60, 1)])
def test_warp_kernel_matches_plain(cuda, compat, shape):
    """Same rounding in the same order: the kernel equals warp_plain bit for
    bit on the card (and so lies within 1e-5 of it)."""
    from tpuvc_torch.ops.warp import warp, warp_kernel, warp_plain

    img, flow = (t.to(cuda) for t in _inputs(shape))
    before = warp_kernel.launches
    out = warp(img, flow, compat)
    assert warp_kernel.launches == before + 1
    ref = warp_plain(img, flow, compat)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5
    assert torch.equal(out, ref)


@pytest.mark.parametrize("compat", ["exact", "flexrate"])
@pytest.mark.parametrize("C", [3, 48, 64, 96, 128])
def test_warp_kernel_channel_widths(cuda, compat, C):
    """Every lane mapping: one lane walking C=3 channels, and C/4 float4
    lanes at 12, 16, 24 and 32 lanes a pixel, at an unaligned width, with
    border clamping and with the zero ring."""
    from tpuvc_torch.ops.warp import warp, warp_plain

    img, flow = (t.to(cuda) for t in _inputs((2, 9, 1917, C), scale=6.0, seed=C))
    out = warp(img, flow, compat)
    ref = warp_plain(img, flow, compat)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past an aligned
    address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("C", [3, 64])
def test_warp_kernel_misaligned_tensors(cuda, C):
    """A frame or flow that does not start on a 16- or 8-byte boundary
    takes the scalar loads, with the same bits."""
    from tpuvc_torch.ops.warp import warp, warp_plain

    img, flow = (t.to(cuda) for t in _inputs((1, 13, 50, C), seed=1))
    ref = warp_plain(img, flow, "exact")
    out = warp(_misaligned(img), _misaligned(flow), "exact")
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("compat", ["exact", "lhbdc", "flexrate"])
def test_warp_and_blend_runs_the_kernel(cuda, compat):
    """On CUDA tensors warp_and_blend launches the warp kernel for each
    direction and equals the blend of two warp_plain calls bit for bit."""
    from tpuvc_torch.ops.warp import warp_and_blend, warp_kernel, warp_plain

    img_fw, flow_fw = (t.to(cuda) for t in _inputs((2, 37, 64, 3), seed=3))
    img_bw, flow_bw = (t.to(cuda) for t in _inputs((2, 37, 64, 3), seed=4))
    mask = torch.rand((2, 37, 64, 1), generator=torch.Generator().manual_seed(5)).to(cuda)
    before = warp_kernel.launches
    out = warp_and_blend(img_fw, flow_fw, img_bw, flow_bw, mask, compat)
    assert warp_kernel.launches == before + 2
    ref = (mask * warp_plain(img_fw, flow_fw, compat)
           + (1.0 - mask) * warp_plain(img_bw, flow_bw, compat))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_warp_kernel_repeat_launch_is_bit_identical(cuda):
    from tpuvc_torch.ops.warp import warp_kernel

    img, flow = (t.to(cuda) for t in _inputs((2, 136, 240, 128), scale=20.0, seed=2))
    first = warp_kernel(img, flow, zero=True)
    assert torch.equal(warp_kernel(img, flow, zero=True), first)


def test_warp_kernel_rejects_what_it_does_not_take(cuda):
    from tpuvc_torch.ops.warp import warp_kernel

    img, flow = (t.to(cuda) for t in _inputs((1, 16, 16, 3)))
    with pytest.raises(ValueError):
        warp_kernel(img.double(), flow.double())
    with pytest.raises(ValueError):
        warp_kernel(img.transpose(1, 2), flow)
    with pytest.raises(ValueError):
        warp_kernel(img, flow[..., :1])
    with pytest.raises(ValueError):
        warp_kernel(img.cpu(), flow.cpu())


@pytest.mark.parametrize("compat", ["exact", "lhbdc", "flexrate"])
@pytest.mark.parametrize("C", [3, 48])
@pytest.mark.parametrize("y0,rows", [(0, 37), (0, 9), (14, 11), (20, 17), (36, 1)])
def test_warp_kernel_rows_match_plain_and_the_whole_frame(cuda, compat, C, y0, rows):
    """A launch for output rows [y0, y0 + rows) (y0 at the first, a middle
    and the last row; ragged row counts) equals warp_plain with the same y0
    and those rows of a whole-frame launch, bit for bit: the clamp and the
    lhbdc H/(H-1) scale are the reference's."""
    from tpuvc_torch.ops.warp import warp, warp_kernel, warp_plain

    img, flow = (t.to(cuda) for t in _inputs((2, 37, 53, C), scale=6.0, seed=C + y0))
    full = warp(img, flow, compat)
    part = flow[:, y0:y0 + rows].contiguous()
    before = warp_kernel.launches
    out = warp(img, part, compat, y0)
    assert warp_kernel.launches == before + 1
    assert out.shape == (2, rows, 53, C)
    ref = warp_plain(img, part, compat, y0)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(out, full[:, y0:y0 + rows])


def test_warp_kernel_refuses_rows_outside_the_reference(cuda):
    from tpuvc_torch.ops.warp import warp_kernel

    img, flow = (t.to(cuda) for t in _inputs((1, 16, 16, 3)))
    with pytest.raises(ValueError, match="does not fit"):
        warp_kernel(img, flow[:, :4].contiguous(), y0=13)
    with pytest.raises(ValueError, match="does not fit"):
        warp_kernel(img, flow[:, :4].contiguous(), y0=-1)


@pytest.mark.parametrize("img_grad", [True, False])
@pytest.mark.parametrize("compat", ["lhbdc", "flexrate"])
def test_warp_backward_matches_plain(cuda, compat, img_grad):
    from tpuvc_torch.ops.warp import warp, warp_plain

    img, flow = (t.to(cuda) for t in _inputs((1, 24, 40, 3), scale=2.0))
    g = torch.rand_like(img)
    grads = []
    for fn in (warp, warp_plain):
        i = img.clone().requires_grad_(img_grad)
        f = flow.clone().requires_grad_()
        (fn(i, f, compat) * g).sum().backward()
        grads.append((i.grad, f.grad))
    (ki, kf), (pi, pf) = grads
    assert torch.allclose(kf, pf, atol=1e-5)
    assert (ki is None) == (not img_grad)
    if img_grad:
        assert torch.allclose(ki, pi, atol=1e-5)


def _frames(shape, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random(shape, dtype=np.float32)
    drift = 0.05 * rng.standard_normal(shape).astype(np.float32)
    return [
        torch.from_numpy(a)
        for a in (base, np.clip(base + 0.5 * drift, 0, 1), np.clip(base + drift, 0, 1))
    ]


def test_lhbdc_forward_card_matches_cpu(cuda):
    """float32 with TF32 off: the card's forward (warp kernel, cuDNN) agrees
    with the CPU's (plain warp) within summation-order noise."""
    from tpuvc_torch.models.lhbdc import LHBDC

    model = LHBDC(N=16, generator=torch.Generator().manual_seed(0)).eval()
    xb, xc, xa = _frames((2, 64, 64, 3))
    with torch.no_grad():
        ref = model(xb, xc, xa, "dequantize")
        model.to(cuda)
        out = model(xb.to(cuda), xc.to(cuda), xa.to(cuda), "dequantize")
    assert float((out["x_hat"].cpu() - ref["x_hat"]).abs().max()) <= 1e-4
    assert abs(float(out["bits"]) / float(ref["bits"]) - 1.0) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_batch_round_trip_on_card(cuda, dtype):
    """The port's main path at a small size on the card: level-batched
    encode, then decode through the async pair, bit-exact, via the kernel."""
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import BFrameBitstream
    from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder
    from tpuvc_torch.ops.precision import policy_from_name
    from tpuvc_torch.ops.warp import warp_kernel

    coder = LHBDCCoder(LHBDC(N=16, generator=torch.Generator().manual_seed(0)))
    xb, xc, xa = (t.to(cuda) for t in _frames((2, 64, 64, 3)))
    warp_kernel.launches = 0
    try:
        with policy_from_name(dtype):
            resolve, x_hat = coder.encode_level_batch_async(xb, xc, xa, rate_id=3)
            streams = [BFrameBitstream.deserialize(b.serialize()) for b in resolve()]
            dec = coder.decode_level_batch_async(streams)(xb, xa)
    finally:
        parallel.shutdown()
    assert torch.equal(dec, x_hat)
    # One warp per SPyNet pyramid level (2 at 64x64) and 2 compensation
    # warps: the encoder runs SPyNet twice, the decoder once.
    assert warp_kernel.launches == (2 * 2 + 2) + (2 + 2)


def _deform_inputs(B, H, W, G, Cg, Og, spread, seed=0):
    rng = np.random.default_rng(seed)
    T = 9
    x = rng.standard_normal((B, H, W, G * Cg)).astype(np.float32)
    off = (spread * rng.standard_normal((B, H, W, G * T * 2))).astype(np.float32)
    masks = rng.random((B, H, W, G * T), dtype=np.float32)
    weight = (rng.standard_normal((G * Og, Cg, 3, 3)) / np.sqrt(T * Cg)).astype(np.float32)
    bias = rng.standard_normal(G * Og).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, off, masks, weight, bias)]


# (B, H, W, G, Cg, Og, offset spread in px): the v4 path's three group
# widths (Cg 8/12/16, float4 lanes; 16 also with its weights read from
# device memory), Cg=5 (scalar lanes), Og=11, and G=1 Cg=64 Og=128 whose
# weights exceed shared memory; widths that leave a ragged last pixel tile
# (the tile is 32 pixels of a row) and spreads whose samples leave the frame.
DEFORM_CASES = [
    (2, 24, 40, 16, 8, 4, 3.0),
    (1, 17, 29, 16, 12, 6, 20.0),
    (1, 9, 13, 2, 5, 11, 1.5),
    (1, 6, 7, 1, 64, 128, 2.0),
    (1, 19, 45, 16, 16, 8, 10.0),
    (1, 11, 70, 4, 8, 11, 40.0),
    (2, 5, 33, 3, 5, 4, 6.0),
    (1, 7, 97, 2, 12, 128, 3.0),
]


@pytest.mark.parametrize("case", DEFORM_CASES)
def test_deform_kernel_matches_plain(cuda, case):
    """Taps summed outer and channels inner in both; the plain version's
    per-tap channel contraction sums in cuBLAS's order: bar 2e-5 on O(1)
    outputs."""
    from tpuvc_torch.ops.deform import deform_conv2d, deform_kernel, deform_plain

    B, H, W, G, Cg, Og, spread = case
    x, off, masks, weight, bias = (t.to(cuda) for t in _deform_inputs(B, H, W, G, Cg, Og, spread))
    before = deform_kernel.launches
    out = deform_conv2d(x, off, masks, weight, bias, G)
    assert deform_kernel.launches == before + 1
    ref = deform_plain(x, off, masks, weight, bias, G)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 2e-5
    # deterministic: the same launch gives the same bits
    assert torch.equal(deform_kernel(x, off, masks, weight, bias, G), out)


# DeformB's (v3) three levels at 1088x1920, B=1: 8 groups of 4, 8, 12
# channels in and out (the kernel's <V=4, MAXO=8> instance), offsets of a
# few px.
V3_DEFORM_CASES = [
    (1, 544, 960, 8, 4, 4, 3.0),
    (1, 272, 480, 8, 8, 8, 3.0),
    (1, 136, 240, 8, 12, 12, 3.0),
]


@pytest.mark.parametrize("case", V3_DEFORM_CASES)
def test_deform_kernel_at_the_v3_shapes(cuda, case):
    from tpuvc_torch.ops.deform import deform_kernel, deform_plain

    B, H, W, G, Cg, Og, spread = case
    args = [t.to(cuda) for t in _deform_inputs(B, H, W, G, Cg, Og, spread, seed=Cg)]
    out = deform_kernel(*args, G)
    ref = deform_plain(*args, G)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 2e-5


@pytest.mark.parametrize("misaligned", [False, True])
def test_deform_wide_launches_count_the_wide_instance(cuda, misaligned):
    """``deform.launches.wide`` counts the launches that csrc/deform.cu sends
    to its <V, MAXO> instance: V = 4 where the group width divides by 4 and
    x is 16-byte aligned (else 1), and more than 2 outputs a lane,
    ceil(Og / (Cg / V)). v3's shapes take it, v4's do not."""
    from tpuvc_torch import obs
    from tpuvc_torch.ops.deform import deform_kernel

    for B, H, W, G, Cg, Og, spread in DEFORM_CASES + V3_DEFORM_CASES:
        H = min(H, 24)
        x, off, masks, weight, bias = (t.to(cuda) for t in
                                       _deform_inputs(B, H, W, G, Cg, Og, spread))
        if misaligned:
            x = _misaligned(x)
        V = 4 if Cg % 4 == 0 and x.data_ptr() % 16 == 0 else 1
        wide = -(-Og // (Cg // V)) > 2
        before = obs.counters()
        deform_kernel(x, off, masks, weight, bias, G)
        after = obs.counters()
        assert after["deform.launches"] == before["deform.launches"] + 1
        assert after["deform.launches.wide"] == before["deform.launches.wide"] + wide, \
            (B, H, W, G, Cg, Og)
        if (G, Cg, Og) == (8, 4, 4) and not misaligned:
            assert wide  # v3's first level


def test_deform_kernel_misaligned_input(cuda):
    """x that does not start on a 16-byte boundary takes the scalar lanes."""
    from tpuvc_torch.ops.deform import deform_kernel, deform_plain

    x, off, masks, weight, bias = (t.to(cuda) for t in _deform_inputs(1, 9, 37, 4, 8, 4, 3.0))
    ref = deform_plain(x, off, masks, weight, bias, 4)
    out = deform_kernel(_misaligned(x), off, masks, weight, bias, 4)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 2e-5


def test_deform_kernel_misaligned_wide_input(cuda):
    """x misaligned with 512 < C <= 2048 and C/G % 4 == 0: the kernel would
    take one lane per channel, more than 512; the wrapper decides the lanes
    as the kernel does, hands it an aligned copy, and returns a result."""
    from tpuvc_torch.ops.deform import deform_kernel, deform_plain, lane_width

    G, Cg = 16, 40  # C = 640
    x, off, masks, weight, bias = (t.to(cuda) for t in _deform_inputs(1, 9, 37, G, Cg, 4, 3.0))
    xm = _misaligned(x)
    assert lane_width(Cg, xm.data_ptr()) == 1 and lane_width(Cg, x.data_ptr()) == 4
    ref = deform_plain(x, off, masks, weight, bias, G)
    out = deform_kernel(xm, off, masks, weight, bias, G)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 2e-5
    assert torch.equal(out, deform_kernel(x, off, masks, weight, bias, G))


def test_deform_kernel_repeat_launch_is_bit_identical(cuda):
    """Encoder and decoder run the same launch: it gives the same bits, at a
    v4-like width with offsets that leave the frame."""
    from tpuvc_torch.ops.deform import deform_kernel

    args = [t.to(cuda) for t in _deform_inputs(2, 40, 150, 16, 8, 4, 15.0, seed=3)]
    first = deform_kernel(*args, 16)
    assert torch.equal(deform_kernel(*args, 16), first)


def test_deform_kernel_without_masks_or_bias(cuda):
    from tpuvc_torch.ops.deform import deform_conv2d, deform_plain

    x, off, _, weight, _ = (t.to(cuda) for t in _deform_inputs(1, 12, 20, 4, 3, 2, 2.0))
    out = deform_conv2d(x, off, None, weight, None, 4)
    ref = deform_plain(x, off, None, weight, None, 4)
    assert float((out - ref).abs().max()) <= 2e-5


def test_deform_kernel_rejects_what_it_does_not_take(cuda):
    from tpuvc_torch.ops.deform import deform_kernel

    x, off, masks, weight, bias = (t.to(cuda) for t in _deform_inputs(1, 8, 8, 2, 2, 2, 1.0))
    with pytest.raises(ValueError):
        deform_kernel(x.double(), off, masks, weight, bias, 2)
    with pytest.raises(ValueError):
        deform_kernel(x, off[..., :-2], masks, weight, bias, 2)
    with pytest.raises(ValueError):
        deform_kernel(x, off, masks, weight, bias[:-1], 2)
    with pytest.raises(ValueError):
        deform_kernel(x.cpu(), off.cpu(), masks.cpu(), weight.cpu(), bias.cpu(), 2)


# (B, H, W, G, Cg, Og, y0, rows): rows [y0, y0 + rows) of a frame of H rows
# at the v4 (16 groups of 8 -> 4) and v3 (8 groups of 4 -> 4) group shapes,
# float4 lanes; scalar lanes (Cg=5); an odd y0, one row, all rows, rows that
# end at the frame's last row.
DEFORM_ROW_CASES = [
    (2, 40, 53, 16, 8, 4, 10, 10),
    (1, 40, 53, 16, 8, 4, 17, 1),
    (1, 33, 70, 16, 8, 4, 21, 12),
    (2, 40, 53, 8, 4, 4, 30, 10),
    (1, 40, 53, 8, 4, 4, 0, 40),
    (1, 29, 37, 8, 4, 4, 28, 1),
    (2, 29, 37, 3, 5, 4, 7, 9),
    (1, 29, 37, 3, 5, 4, 0, 29),
]


@pytest.mark.parametrize("case", DEFORM_ROW_CASES)
def test_deform_kernel_rows_match_plain_and_the_whole_frame(cuda, case):
    """A launch for output rows [y0, y0 + rows) from offsets and masks of
    those rows equals those rows of a whole-frame launch bit for bit, and
    deform_plain with the same y0 within the kernel's bar; offsets of 15 px
    reach well past the rows and out of the frame."""
    from tpuvc_torch.ops.deform import deform_conv2d, deform_kernel, deform_plain, lane_width

    B, H, W, G, Cg, Og, y0, rows = case
    x, off, masks, weight, bias = (t.to(cuda) for t in _deform_inputs(B, H, W, G, Cg, Og, 15.0,
                                                                      seed=y0 + rows))
    assert lane_width(Cg, x.data_ptr()) == (4 if Cg % 4 == 0 else 1)
    full = deform_kernel(x, off, masks, weight, bias, G)
    part = [t[:, y0:y0 + rows].contiguous() for t in (off, masks)]
    before = deform_kernel.launches
    out = deform_conv2d(x, part[0], part[1], weight, bias, G, 3, y0)
    assert deform_kernel.launches == before + 1
    ref = deform_plain(x, part[0], part[1], weight, bias, G, 3, y0)
    torch.cuda.synchronize()
    assert out.shape == (B, rows, W, G * Og)
    assert torch.equal(out, full[:, y0:y0 + rows])
    assert float((out - ref).abs().max()) <= 2e-5


def test_deform_kernel_refuses_rows_outside_the_frame(cuda):
    from tpuvc_torch.ops.deform import deform_kernel

    x, off, masks, weight, bias = (t.to(cuda) for t in _deform_inputs(1, 8, 8, 2, 2, 2, 1.0))
    with pytest.raises(ValueError, match="do not fit"):
        deform_kernel(x, off[:, :4].contiguous(), masks[:, :4].contiguous(), weight, bias, 2,
                      3, 5)
    with pytest.raises(ValueError, match="do not fit"):
        deform_kernel(x, off[:, :4].contiguous(), masks[:, :4].contiguous(), weight, bias, 2,
                      3, -1)


def test_deform_backward_matches_plain(cuda):
    from tpuvc_torch.ops.deform import deform_conv2d, deform_plain

    ins = [t.to(cuda) for t in _deform_inputs(1, 10, 14, 2, 3, 2, 2.0, seed=1)]
    g = torch.rand((1, 10, 14, 4), device=cuda)
    grads = []
    for fn in (deform_conv2d, deform_plain):
        ts = [t.clone().requires_grad_() for t in ins]
        (fn(*ts, 2) * g).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, atol=1e-4, rtol=1e-4)


def _v4_model():
    import chip_smoke

    return chip_smoke.v4_model(torch, N=32, seed=0, feature_channels=(16, 32, 48),
                               levels=3, groups=(4, 4, 8, 16))


def test_flowguided_forward_card_matches_cpu(cuda):
    """float32 with TF32 off: the card's forward (warp and deform kernels,
    cuDNN) agrees with the CPU's (plain versions) within summation-order
    noise."""
    model = _v4_model().eval()
    x1, xc, x2 = _frames((2, 64, 64, 3))
    with torch.no_grad():
        ref = model(x1, x2, xc, 1.0, 0.5, 0.5, 1, "dequantize")
        model.to(cuda)
        out = model(x1.to(cuda), x2.to(cuda), xc.to(cuda), 1.0, 0.5, 0.5, 1, "dequantize")
    scale = max(1.0, float(ref["x_hat"].abs().max()))
    assert float((out["x_hat"].cpu() - ref["x_hat"]).abs().max()) <= 1e-4 * scale
    assert abs(float(out["size"]) / float(ref["size"]) - 1.0) <= 1e-5


def test_host_step_reads_after_the_copy_and_waits_off_the_interpreter_lock(cuda):
    """A stepwise decode's host round trip: the calling thread only issues
    the index copy, the worker reads the indexes only once the copy, queued
    behind ~0.25 s of device work, has landed, and its wait on the copy's
    event leaves the interpreter to the calling thread."""
    import time

    from tpuvc_torch.coder import parallel

    def total(a):
        return int(a.astype(np.int64).sum())

    x = torch.arange(1000, dtype=torch.int32, device=cuda)
    try:
        # kernels loaded, pinned memory and workers warm
        parallel.run_steps(parallel.host_step(total, x * 2))
        torch.cuda.synchronize()
        torch.cuda._sleep(int(5e8))
        t0 = time.perf_counter()
        step = parallel.host_step(total, x * 2)
        fut = next(step)
        issued = time.perf_counter() - t0
        spins = 0
        while not fut.done():
            spins += 1
        waited = time.perf_counter() - t0
        with pytest.raises(StopIteration) as stop:
            next(step)
    finally:
        parallel.shutdown()
    assert stop.value.value == 999000
    assert issued < 0.05 < waited, (issued, waited)
    assert spins > 10000, (spins, waited)


def test_flowguided_paired_decode_on_card_is_bit_exact(cuda):
    """Two full-width 1088x1920 chunks of batch 2, their stepwise decodes
    run in turn on one thread (each phase's index fetch ordered by its
    event while the partner's kernels queue behind it), equal their decodes
    one after the other and the encoder's reconstructions, in bfloat16."""
    import chip_smoke
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import VFrameBitstream
    from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder
    from tpuvc_torch.ops.precision import policy_from_name

    coder = FlowGuidedBCoder(chip_smoke.v4_model(torch))
    chunks = []
    try:
        with policy_from_name("bfloat16"):
            for seed, scales in ((11, (0.5, -0.5)), (12, (0.25, -0.75))):
                x1, xc, x2 = (t.to(cuda) for t in _frames((2, 1088, 1920, 3), seed=seed))
                bits, x_hat = coder.encode_level_batch(x1, x2, xc, 1.0, *scales)
                parsed = [VFrameBitstream.deserialize(b.serialize()) for b in bits]
                chunks.append((x1, x2, parsed, x_hat))
            one_by_one = [coder.decode_level_batch(x1, x2, p) for x1, x2, p, _ in chunks]
            paired = parallel.run_steps(*(coder.decode_level_batch_steps(x1, x2, p)
                                          for x1, x2, p, _ in chunks))
    finally:
        parallel.shutdown()
    for (_, _, _, x_hat), single, both in zip(chunks, one_by_one, paired):
        assert torch.equal(single, x_hat)
        assert torch.equal(both, single)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flowguided_round_trip_on_card(cuda, dtype):
    """The v4 path at a small size on the card: level-batched encode, then
    decode, bit-exact, through both kernels."""
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import VFrameBitstream
    from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder
    from tpuvc_torch.ops.deform import deform_kernel
    from tpuvc_torch.ops.precision import policy_from_name
    from tpuvc_torch.ops.warp import warp_kernel

    coder = FlowGuidedBCoder(_v4_model())
    x1, xc, x2 = (t.to(cuda) for t in _frames((2, 64, 64, 3)))
    warp_kernel.launches = deform_kernel.launches = 0
    try:
        with policy_from_name(dtype):
            bits, x_hat = coder.encode_level_batch(x1, x2, xc, 1.0, 0.5, 0.5)
            parsed = [VFrameBitstream.deserialize(b.serialize()) for b in bits]
            dec = coder.decode_level_batch(x1, x2, parsed)
    finally:
        parallel.shutdown()
    assert torch.equal(dec, x_hat)
    # 2 feature warps and 1 deform conv per pyramid level, on each side.
    assert warp_kernel.launches == 2 * 6
    assert deform_kernel.launches == 2 * 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elic_batch_round_trip_on_card(cuda, dtype):
    """ELIC at full width (N=192, M=320), seeded weights, three 256x256
    frames (a 2-GOP window's fresh anchors): decompress_batch equals the
    encoder's synthesis bit for bit on the card."""
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.models.elic import ELIC, ELICCoder
    from tpuvc_torch.ops.precision import policy_from_name

    coder = ELICCoder(ELIC(generator=torch.Generator().manual_seed(0)))
    x = torch.cat(_frames((1, 256, 256, 3), seed=4)).to(cuda)
    try:
        with policy_from_name(dtype):
            enc = coder.compress_batch(x)
            dec = coder.decompress_batch(enc["strings"], enc["shape"])
            assert torch.equal(dec, coder.synthesize(enc["y_hat"]))
    finally:
        parallel.shutdown()
    assert enc["shape"] == (4, 4) and len(enc["strings"]) == 3


@pytest.mark.parametrize("family", ["lhbdc", "flowguided_b", "deform_b", "flexrate"])
def test_sequence_cli_round_trip_on_card(cuda, tmp_path, family):
    """encode_v then decode_v with --device cuda at 128x128 (9 frames, GOP
    4, small LHBDC, Flex-Rate and ELIC; FlowGuidedB and DeformB at full
    width; zero-initialised heads seeded): the decode equals the encoder's
    reconstructions, through the kernels."""
    import chip_smoke
    from tpuvc_torch.cli import decode_v, encode_v
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.ops.deform import deform_kernel
    from tpuvc_torch.ops.warp import warp_kernel

    model = ["--init", "random", "--N", "32", "--intra_N", "16", "--intra_M", "24",
             "--intra_groups", "4,4,16", "--device", "cuda"]
    mode = (["--level_batched", "--window_gops", "2", "--max_batch", "4"]
            if family in ("lhbdc", "flexrate") else ["--s", "1.0"])
    bin_path = str(tmp_path / "seq.tpvb")
    warp_kernel.launches = deform_kernel.launches = 0
    try:
        with chip_smoke.cli_heads_seeded():
            enc = encode_v.main(["--synthetic", "9", "--width", "128", "--height", "128",
                                 "--gop", "4", "--family", family, "--compute_dtype",
                                 "bfloat16", "--bin", bin_path] + mode + model)
            dec = decode_v.main(["--bin", bin_path, "--out_dir", str(tmp_path / "dec")] + model)
    finally:
        parallel.shutdown()
    assert sorted(enc) == sorted(dec) == list(range(9))
    assert all(torch.equal(enc[i], dec[i]) for i in enc)
    assert (warp_kernel.launches > 0) == (family != "deform_b")
    assert (deform_kernel.launches > 0) == (family in ("flowguided_b", "deform_b"))


@pytest.mark.parametrize("compat, shape", [
    ("exact", (1, 1088, 1920, 3)),  # the down-ratio search's flow-only predictions
    ("lhbdc", (32, 34, 60, 3)),     # SPyNet's coarsest level in the batch-8 eval forward
])
def test_warp_kernel_at_the_eval_shapes(cuda, compat, shape):
    from tpuvc_torch.ops.warp import warp, warp_plain

    img, flow = (t.to(cuda) for t in _inputs(shape, seed=7))
    out = warp(img, flow, compat)
    ref = warp_plain(img, flow, compat)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("B", [1, 2])
def test_warp_kernel_at_the_flexrate_shapes(cuda, B):
    """Flex-Rate's four full-resolution warps: half-pixel shift over a zero
    ring, at B=1 (a sequential frame) and B=2."""
    from tpuvc_torch.ops.warp import warp, warp_plain

    img, flow = (t.to(cuda) for t in _inputs((B, 1088, 1920, 3), seed=8))
    out = warp(img, flow, "flexrate")
    ref = warp_plain(img, flow, "flexrate")
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _v3_model():
    import chip_smoke

    return chip_smoke.v3_model(torch, N=32, seed=0, feature_channels=(8, 16, 24),
                               levels=3, groups=(4, 4, 8, 16))


def _flexrate_model():
    import chip_smoke

    return chip_smoke.flexrate_model(torch, N=32, seed=0, n_levels=4)


@pytest.mark.parametrize("family", ["deform_b", "flexrate"])
def test_v3_and_flexrate_forward_card_matches_cpu(cuda, family):
    """float32 with TF32 off: DeformB's (deform kernel) and Flex-Rate's
    (warp kernel) forwards on the card agree with the CPU's within
    summation-order noise."""
    if family == "deform_b":
        model, hw = _v3_model().eval(), 64
        fwd = lambda m, x1, xc, x2: m(x1, x2, xc, 1.0, "dequantize")
    else:
        model, hw = _flexrate_model().eval(), 128
        fwd = lambda m, x1, xc, x2: m(x1, xc, x2, 1, 0.66, "dequantize")
    x1, xc, x2 = _frames((2, hw, hw, 3))
    with torch.no_grad():
        ref = fwd(model, x1, xc, x2)
        model.to(cuda)
        out = fwd(model, x1.to(cuda), xc.to(cuda), x2.to(cuda))
    scale = max(1.0, float(ref["x_hat"].abs().max()))
    assert float((out["x_hat"].cpu() - ref["x_hat"]).abs().max()) <= 1e-4 * scale
    assert abs(float(out["size"].sum()) / float(ref["size"].sum()) - 1.0) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["deform_b", "flexrate"])
def test_v3_and_flexrate_round_trip_on_card(cuda, family, dtype):
    """Level-batched encode, then decode, bit-exact, on the card: DeformB
    through its six deform convs a side, Flex-Rate through its four
    flexrate warps a side (its decode through the async pair)."""
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.models.deform_b import DeformBCoder
    from tpuvc_torch.models.flexrate import FlexRateCoder
    from tpuvc_torch.ops.deform import deform_kernel
    from tpuvc_torch.ops.precision import policy_from_name
    from tpuvc_torch.ops.warp import warp_kernel

    warp_kernel.launches = deform_kernel.launches = 0
    try:
        with policy_from_name(dtype):
            if family == "deform_b":
                coder = DeformBCoder(_v3_model())
                x1, xc, x2 = (t.to(cuda) for t in _frames((2, 64, 64, 3)))
                bits, x_hat = coder.encode_level_batch(x1, x2, xc, 1.0)
                parsed = [type(b).deserialize(b.serialize()) for b in bits]
                dec = coder.decode_level_batch(x1, x2, parsed)
            else:
                coder = FlexRateCoder(_flexrate_model())
                x1, xc, x2 = (t.to(cuda) for t in _frames((2, 128, 128, 3)))
                bits, x_hat = coder.encode_level_batch(x1, xc, x2, 1, 0.66)
                parsed = [type(b).deserialize(b.serialize()) for b in bits]
                dec = coder.decode_level_batch_async(parsed)(x1, x2)
    finally:
        parallel.shutdown()
    assert torch.equal(dec, x_hat)
    if family == "deform_b":
        assert (deform_kernel.launches, warp_kernel.launches) == (2 * 6, 0)
    else:
        assert (deform_kernel.launches, warp_kernel.launches) == (0, 2 * 4)


@pytest.mark.parametrize("down_ratio", [2, 4])
def test_flowguided_down_ratio_round_trip_on_card(cuda, down_ratio):
    """FlowGuidedB (small, heads seeded) coded at a down ratio above 1 at
    128x128 on the card: the stream carries the ratio and decodes to the
    encoder's reconstruction bit for bit."""
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import VFrameBitstream
    from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder

    coder = FlowGuidedBCoder(_v4_model())
    x1, xc, x2 = (t.to(cuda) for t in _frames((1, 128, 128, 3), seed=5))
    try:
        bits, x_hat = coder.encode_recon(x1, x2, xc, 1.0, 0.5, 0.5, down_ratio=down_ratio)
        parsed = VFrameBitstream.deserialize(bits.serialize())
        dec = coder.decode(x1, x2, parsed)
    finally:
        parallel.shutdown()
    assert parsed.down_ratio == down_ratio
    assert torch.equal(dec, x_hat)


def test_msssim_card_matches_cpu(cuda):
    """MS-SSIM at 192x192 (float32, TF32 off): the card's depthwise blur
    convolutions agree with the CPU's within 1e-5."""
    from tpuvc_torch.eval.metrics import msssim

    rng = np.random.default_rng(11)
    a = rng.random((1, 192, 192, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    ref = float(msssim(a, b))
    out = float(msssim(a.to(cuda), b.to(cuda)))
    assert 0.0 < ref < 1.0
    assert abs(out - ref) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 1088, 1920, 48), (1, 1081, 1917, 48)])
def test_warp_kernel_at_the_dmc_shapes(cuda, shape):
    """DMC's 48-channel feature warp (exact mode) at its path's 1088x1920
    and at an unaligned size: bit for bit with warp_plain."""
    from tpuvc_torch.ops.warp import warp, warp_plain

    img, flow = (t.to(cuda) for t in _inputs(shape, seed=9))
    out = warp(img, flow, "exact")
    ref = warp_plain(img, flow, "exact")
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("ratio", [1.25, 1.5, 2.0, 3.0, 8.75])
def test_resize_antialias_card_matches_cpu(cuda, ratio):
    """The antialiased down-sampling of DMC's fractional ratios (two float32
    weight-matrix products) on the card against the CPU."""
    from tpuvc_torch.models.dmc import resize_antialias

    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.random((1, 192, 256, 3), dtype=np.float32))
    h = max(int(round(192 / ratio)) // 8 * 8, 64)
    w = max(int(round(256 / ratio)) // 8 * 8, 64)
    ref = resize_antialias(x, h, w)
    out = resize_antialias(x.to(cuda), h, w).cpu()
    assert out.shape == ref.shape == (1, h, w, 3)
    assert float((out - ref).abs().max()) <= 1e-6


def _dmc_frames(n, h, w, seed):
    """(n, h, w, 3) frames drifting from one seeded base."""
    rng = np.random.default_rng(seed)
    base = rng.random((1, h, w, 3), dtype=np.float32)
    drift = 0.03 * rng.standard_normal((n, h, w, 3)).astype(np.float32)
    return torch.from_numpy(np.clip(base + np.cumsum(drift, axis=0), 0, 1))


def _dmc_model():
    from tpuvc_torch.models.dmc import PFrameDMC

    return PFrameDMC(feat=16, N=32, generator=torch.Generator().manual_seed(0))


def test_dmc_forward_card_matches_cpu(cuda):
    """Two chained P-frames (down ratios 1.0, 1.5) at 128x128 on the card
    against the CPU, at chip_smoke's bars."""
    model = _dmc_model().eval()
    xs = _dmc_frames(3, 128, 128, seed=13)
    outs = []  # per device: [(x_hat, bits)] per frame
    with torch.no_grad():
        for dev in ("cpu", cuda):
            model.to(dev)
            dpb = {"ref_frame": xs[0:1].to(dev), "ref_feature": None, "ref_down_ratio": 1.0}
            outs.append([])
            for i, ratio in ((1, 1.0), (2, 1.5)):
                out = model(xs[i : i + 1].to(dev), dpb, ratio, "dequantize")
                outs[-1].append((out["x_hat"].cpu(), float(out["bits"])))
                dpb = out["dpb"]
    for (x_ref, b_ref), (x_out, b_out) in zip(*outs):
        assert float((x_out - x_ref).abs().max()) <= 1e-4 * max(1.0, float(x_ref.abs().max()))
        assert abs(b_out - b_ref) <= 1e-5 * b_ref


def test_dmc_round_trip_on_card(cuda):
    """PFrameDMCCoder on the card at 128x192: three chained P-frames at down
    ratios 1.0, 1.5, 1.5, encoded with encode_async and decoded both by
    decode_sequence and frame by frame with decode; every reconstruction and
    the final DPB equal the encoder's bit for bit, through the warp
    kernel."""
    from tpuvc_torch.models.dmc import PFrameDMCCoder
    from tpuvc_torch.ops.warp import warp_kernel

    coder = PFrameDMCCoder(_dmc_model(), device=cuda)
    xs = _dmc_frames(4, 128, 192, seed=14).to(cuda)
    dpb = {"ref_frame": xs[0:1], "ref_feature": None, "ref_down_ratio": 1.0}
    warp_kernel.launches = 0
    try:
        enc_dpb, futs, recons = dpb, [], []
        for i, ratio in ((1, 1.0), (2, 1.5), (3, 1.5)):
            fut, enc_dpb = coder.encode_async(xs[i : i + 1], enc_dpb, ratio=ratio, q=0.5)
            futs.append(fut)
            recons.append(enc_dpb["ref_frame"])
        bits = [f.result() for f in futs]
        xs_dec, dec_dpb = coder.decode_sequence(dpb, bits)
        folded = dpb
        for b, r in zip(bits, recons):
            x_hat, folded = coder.decode(folded, b)
            assert torch.equal(torch.clamp(x_hat, 0, 1), r)
    finally:
        coder.close()
    assert [b.ratio_centi for b in bits] == [100, 150, 150]
    assert all(torch.equal(torch.clamp(x, 0, 1), r) for x, r in zip(xs_dec, recons))
    for k in ("ref_frame", "ref_feature", "ref_mv_feature", "ref_y", "ref_mv_y"):
        assert torch.equal(dec_dpb[k], enc_dpb[k]) and torch.equal(folded[k], enc_dpb[k])
    assert warp_kernel.launches > 0


# --- training (cli/train.py's steps) on the card --------------------------

def _grad_rel_err(got, ref):
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    return err / scale if scale else err


def _window(T, B=2, hw=64, seed=20):
    rng = np.random.default_rng(seed)
    base = rng.random((B, 1, hw, hw, 3), dtype=np.float32)
    drift = 0.05 * rng.standard_normal((B, 1, hw, hw, 3)).astype(np.float32)
    t = np.arange(T, dtype=np.float32).reshape(1, T, 1, 1, 1) - T // 2
    return torch.from_numpy(np.clip(base + t * drift, 0, 1).astype(np.float32))


def _grads_agree(g_card, g_cpu):
    """Card against CPU gradients, per tensor relative to its max: the
    median within 1e-4, the worst within 5e-2 (float32 rounding on either
    device can flip a sample point's bilinear cell or a latent's rounding
    bin; the LHBDC smoke step measured 1.14e-2 at worst, 4.5e-6 median)."""
    errs = sorted(_grad_rel_err(a, b) for a, b in zip(g_card, g_cpu))
    assert errs[len(errs) // 2] <= 1e-4 and errs[-1] <= 5e-2, errs[-5:]


def test_lhbdc_training_step_on_card(cuda):
    """LHBDC(N=32) 'ste' step: the loss and gradients on the card against the
    CPU (loss 1e-4 relative, gradients as _grads_agree), then a full step
    through the warp kernel that moves every quantile."""
    from tpuvc_torch.models.lhbdc import LHBDC
    from tpuvc_torch.ops.warp import warp_kernel
    from tpuvc_torch.train.trainer import make_lhbdc_step, make_optimizer

    model = LHBDC(N=32, generator=torch.Generator().manual_seed(21))
    batch = _window(3)
    got = {}
    for dev in ("cpu", cuda):
        model.to(dev)
        params = dict(model.named_parameters())
        loss, _ = make_lhbdc_step(model, make_optimizer(), 1626.0, mode="ste").loss_fn(
            batch.to(dev), 0)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        got[str(dev)] = (float(loss.detach()), [
            torch.zeros_like(p.detach().cpu()) if g is None else g.cpu()
            for p, g in zip(params.values(), grads)])
    (l_cpu, g_cpu), (l_card, g_card) = got["cpu"], got["cuda"]
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    _grads_agree(g_card, g_cpu)
    tx = make_optimizer()
    params = dict(model.named_parameters())
    q0 = {n: p.detach().clone() for n, p in params.items() if n.endswith("quantiles")}
    warp_kernel.launches = 0
    _, _, metrics = make_lhbdc_step(model, tx, 1626.0)(params, tx.init(params),
                                                       batch.to(cuda), (1, 0))
    assert warp_kernel.launches > 0 and torch.isfinite(metrics["loss"])
    assert all(not torch.equal(q0[n], params[n].detach()) for n in q0)


def test_v4_training_step_on_card(cuda):
    """A narrow FlowGuidedB's recursive step, both stages, in 'ste' on the
    card (deform and warp kernels forward, autograd backward) against the
    CPU: loss 1e-4 relative, gradients as _grads_agree."""
    from tpuvc_torch.cli.train import code_fn_for
    from tpuvc_torch.models.flowguided_b import FlowGuidedB
    from tpuvc_torch.ops.deform import deform_kernel
    from tpuvc_torch.ops.warp import warp_kernel
    from tpuvc_torch.train.trainer import make_optimizer, make_recursive_step

    model = FlowGuidedB(feature_channels=(16, 32, 48), N=32, M=32, levels=3,
                        groups=(4, 4, 8, 16), generator=torch.Generator().manual_seed(22))
    with torch.no_grad():  # fractional offsets and flows, as a trained model's
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(23)))
    batch = _window(5, B=1)
    got = {}
    for dev in ("cpu", cuda):
        model.to(dev)
        params = dict(model.named_parameters())
        step = make_recursive_step(code_fn_for("flowguided_b", model), model.aux_loss,
                                   make_optimizer(), beta=0.0207)
        warp_kernel.launches = deform_kernel.launches = 0
        loss, _ = step.loss_fn(batch.to(dev), 0, True, 1, 2)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        got[str(dev)] = (float(loss.detach()), [
            torch.zeros_like(p.detach().cpu()) if g is None else g.cpu()
            for p, g in zip(params.values(), grads)])
    assert warp_kernel.launches > 0 and deform_kernel.launches > 0
    (l_cpu, g_cpu), (l_card, g_card) = got["cpu"], got["cuda"]
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    _grads_agree(g_card, g_cpu)


@pytest.mark.parametrize("compat, shape", [
    ("lhbdc", (32, 256, 256, 3)), ("lhbdc", (8, 256, 256, 3)), ("flexrate", (8, 256, 256, 3)),
    ("exact", (8, 256, 256, 48)), ("exact", (8, 128, 128, 64)), ("exact", (8, 64, 64, 96)),
    ("exact", (8, 32, 32, 128)),
])
def test_warp_backward_at_the_training_shapes(cuda, compat, shape):
    """The kernel path (kernel forward, autograd of the plain formulation
    backward) against warp_plain's own autograd at batch 8, 256x256 crops:
    the forward bit for bit, the gradients within 1e-5 of their max (the
    gather backward adds with float atomics)."""
    from tpuvc_torch.ops.warp import warp, warp_plain

    img, flow = (t.to(cuda) for t in _inputs(shape, scale=4.0, seed=24))
    g = torch.rand_like(img)
    res = []
    for fn in (warp, warp_plain):
        i, f = img.clone().requires_grad_(), flow.clone().requires_grad_()
        out = fn(i, f, compat)
        res.append((out.detach(), *torch.autograd.grad(out, (i, f), g)))
    (ok, gik, gfk), (op, gip, gfp) = res
    assert torch.equal(ok, op)
    assert _grad_rel_err(gik, gip) <= 1e-5 and _grad_rel_err(gfk, gfp) <= 1e-5


@pytest.mark.parametrize("x_shape, G, C_out", [
    ((8, 128, 128, 128), 16, 64), ((8, 64, 64, 192), 16, 96), ((8, 32, 32, 256), 16, 128),
    ((8, 128, 128, 32), 8, 32), ((8, 64, 64, 64), 8, 64), ((8, 32, 32, 96), 8, 96),
])
def test_deform_backward_at_the_training_shapes(cuda, x_shape, G, C_out):
    """deform_conv2d (kernel forward, autograd of deform_plain backward)
    against deform_plain's own autograd at the v4 and v3 training shapes:
    the forward within 2e-5, every gradient within 1e-5 of its max."""
    from tpuvc_torch.ops.deform import deform_conv2d, deform_plain

    gen = torch.Generator(device=cuda).manual_seed(25)
    B, H, W, C = x_shape
    T = 9
    inputs = (torch.randn(x_shape, generator=gen, device=cuda),
              2.0 * torch.randn((B, H, W, G * T * 2), generator=gen, device=cuda),
              torch.rand((B, H, W, G * T), generator=gen, device=cuda),
              torch.randn((C_out, C // G, 3, 3), generator=gen, device=cuda) / (T * C // G) ** 0.5,
              0.1 * torch.randn((C_out,), generator=gen, device=cuda))
    g = torch.randn((B, H, W, C_out), generator=gen, device=cuda)
    res = []
    for fn in (deform_conv2d, deform_plain):
        ins = [t.clone().requires_grad_() for t in inputs]
        out = fn(*ins, G, 3)
        res.append((out.detach(), torch.autograd.grad(out, ins, g)))
    (ok, gk), (op, gp) = res
    assert float((ok - op).abs().max()) <= 2e-5
    assert max(_grad_rel_err(a, b) for a, b in zip(gk, gp)) <= 1e-5


def test_nccl_world1_collectives(cuda, tmp_path):
    """A one-rank NCCL group on the card (file:// init, no port): make_mesh
    joins it on cuda:0, and the port's collectives and torch.distributed's
    all_reduce, broadcast and all_gather of CUDA tensors give their inputs
    back."""
    import torch.distributed as dist

    from tpuvc_torch.parallel import mesh as M

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init", rank=0, world_size=1)
    try:
        mesh = M.make_mesh(1, backend="nccl")
        assert (mesh.size, mesh.rank, mesh.backend, mesh.device) == (1, 0, "nccl",
                                                                    torch.device("cuda", 0))
        x = torch.arange(12.0, device=mesh.device).reshape(6, 2)
        y = x.clone()
        dist.all_reduce(y, group=mesh.group)
        z = x.clone()
        dist.broadcast(z, src=0, group=mesh.group)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x, group=mesh.group)
        assert torch.equal(y, x) and torch.equal(z, x) and torch.equal(parts[0], x)
        bf = x.to(torch.bfloat16) / 3
        assert torch.equal(M.all_gather_rows(mesh, bf), bf)
        assert torch.equal(M.all_reduce_mean(mesh, x), x)
        assert torch.equal(M.broadcast_(mesh, x.clone()), x)
        assert M.all_gather_objects(mesh, {"rank": 0}) == [{"rank": 0}]
    finally:
        dist.destroy_process_group()


def test_mesh2_gloo_level_batch_round_trip_on_card(cuda, tmp_path):
    """Two gloo ranks share the card (tests/torch_mesh_worker.py's
    coding_card case): LHBDC and FlowGuidedB level batches of 128x128
    frames at B=2 (split) and B=3 (whole on each rank) decode bit for bit
    over the mesh, the ranks agree, and each rank launches the warp (and,
    for FlowGuidedB, the deform) kernel."""
    from torch_mesh_worker import run_ranks

    ranks = run_ranks("coding_card", tmp_path)
    for (fam, b), r0 in ranks[0].items():
        assert r0["recon"].shape == (b, 128, 128, 3)
        for out in ranks:
            got = out[(fam, b)]
            assert torch.equal(got["dec"], got["recon"]) and torch.equal(got["recon"], r0["recon"])
            assert got["blobs"] == r0["blobs"]
            assert got["launches"]["warp"] > 0
            assert fam == "lhbdc" or got["launches"]["deform"] > 0



def test_spatial_lhbdc_forward_over_4_ranks_on_card(cuda, tmp_path):
    """Four gloo ranks share the card (tests/torch_mesh_worker.py's
    spatial_card case): LHBDC(N=32) at 256x192 with its rows sharded,
    against the unsharded forward on the card at tpuvc's bars for its
    sharded forward (x_hat 2e-4, sizes 2e-4 relative); each rank launches
    the warp kernel at its own first row."""
    from torch_mesh_worker import run_ranks, spatial_card_model, spatial_frames
    from tpuvc_torch.parallel.spatial import rows_of

    model = spatial_card_model().to(cuda).eval()
    frames = [torch.from_numpy(x).to(cuda) for x in spatial_frames()]
    with torch.no_grad():
        ref = model(*frames, "dequantize")
    ranks = run_ranks("spatial_card", tmp_path, world=4)
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out["x_hat"], ref["x_hat"].cpu(), rtol=0, atol=2e-4)
        torch.testing.assert_close(out["sizes"], ref["sizes"].cpu(), rtol=2e-4, atol=0)
        assert out["launches"] == len(out["warps"]) == 6
        assert {w[0] for w in out["warps"]} == {rows_of(w[2], 4, r)[0] for w in out["warps"]}


def test_spatial_flowguided_forward_over_2_ranks_on_card(cuda, tmp_path):
    """Two gloo ranks share the card (tests/torch_mesh_worker.py's
    spatial_v4_card case): a narrow FlowGuidedB, heads seeded, at 128x128
    with its rows sharded, against the unsharded forward on the card at
    tpuvc's bars for its sharded forward; each rank launches the warp
    kernel (two a level) and the deform kernel (one a level) at its own
    first row."""
    from torch_mesh_worker import run_ranks, spatial_card_v4_model, spatial_frames
    from tpuvc_torch.parallel.spatial import rows_of

    model = spatial_card_v4_model().to(cuda).eval()
    xb, xc, xa = (torch.from_numpy(x).to(cuda) for x in spatial_frames(128, 128))
    with torch.no_grad():
        ref = model(xb, xa, xc, 1.0, 0.5, -0.5, 1, "dequantize")
    ranks = run_ranks("spatial_v4_card", tmp_path, world=2)
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out["x_hat"], ref["x_hat"].cpu(), rtol=0, atol=2e-4)
        torch.testing.assert_close(out["sizes"], ref["sizes"].cpu(), rtol=2e-4, atol=0)
        launches = dict(out["launches"])
        assert launches.pop("epilogue") > 0  # the conv windows' epilogues
        assert launches == {"warp": 6, "deform": 3}
        assert len(out["warps"]) == 6 and len(out["deforms"]) == 3
        for w in out["warps"] + out["deforms"]:
            assert w[0] == rows_of(w[2], 2, r)[0]


@pytest.mark.parametrize("compat,shape,y0,rows", [
    ("flexrate", (1, 1088, 1920, 3), 272, 272),
    ("flexrate", (1, 1088, 1920, 3), 816, 272),
    ("exact", (1, 1088, 1920, 48), 816, 272),
    ("exact", (1, 1088, 1920, 48), 0, 272),
])
def test_warp_kernel_rows_at_the_spatial_flexrate_and_dmc_shapes(cuda, compat, shape, y0, rows):
    """The sharded Flex-Rate and DMC forwards' warps at 1088x1920 over 4
    ranks: a rank's rows of a flexrate warp (the zero ring) and of DMC's
    48-channel feature warp equal those rows of a whole-frame launch and
    warp_plain with the same y0, bit for bit."""
    from tpuvc_torch.ops.warp import warp, warp_kernel, warp_plain

    img, flow = (t.to(cuda) for t in _inputs(shape, scale=6.0, seed=y0 + shape[-1]))
    full = warp(img, flow, compat)
    part = flow[:, y0:y0 + rows].contiguous()
    before = warp_kernel.launches
    out = warp(img, part, compat, y0)
    assert warp_kernel.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, full[:, y0:y0 + rows])
    assert torch.equal(out, warp_plain(img, part, compat, y0))


@pytest.mark.parametrize("y0,h", [(0, 17), (17, 17), (51, 17), (135, 1)])
def test_dmc_part_masks_of_rows_on_card(cuda, y0, h):
    """DMC's part masks of a rank's rows (its first row's parity; 68 rows
    over 4 ranks start at 0, 17, 34, 51) are those rows of the frame's, on
    the card."""
    from tpuvc_torch.models.dmc import part_mask

    for k in range(4):
        frame = part_mask(136, 240, 64, k, device=cuda)
        assert torch.equal(part_mask(h, 240, 64, k, device=cuda, y0=y0), frame[y0:y0 + h])


def test_spatial_rest_forwards_over_4_ranks_on_card(cuda, tmp_path):
    """Four gloo ranks share the card (tests/torch_mesh_worker.py's
    spatial_rest_card case): Flex-Rate, DMC's two chained P-frames and ELIC
    at the CPU tests' widths and frames, seeded, H-sharded, against the
    unsharded forwards on the card (DMC's second frame from the ranks'
    gathered DPB) at tpuvc's bars for its sharded forward; each rank
    launches the warp kernel at its own first row of each warp, Flex-Rate
    four times, ELIC never."""
    from torch_mesh_worker import REST_DMC_CHAIN, REST_RATE, rest_frames, rest_model, run_ranks
    from tpuvc_torch.parallel.spatial import rows_of

    ranks = run_ranks("spatial_rest_card", tmp_path, world=4)
    with torch.no_grad():
        for family in ("flexrate", "dmc", "elic"):
            model = rest_model(family, seed=0).to(cuda)
            xs = [torch.from_numpy(x).to(cuda) for x in rest_frames(family)]
            if family == "flexrate":
                refs = [model(*xs, *REST_RATE, "dequantize")]
            elif family == "elic":
                out = model(*xs, "dequantize")
                refs = [{"x_hat": out["x_hat"], "bits": model.bits(out["likelihoods"])}]
            else:
                refs = []
                for i, (ratio, q) in enumerate(REST_DMC_CHAIN):
                    dpb = ({"ref_frame": xs[0]} if i == 0 else
                           {k: v if k == "ref_down_ratio" else v.to(cuda)
                            for k, v in ranks[0][(family, i - 1)]["dpb"].items()})
                    refs.append(model(xs[i + 1], dpb, ratio, "dequantize", q=q))
            for i, ref in enumerate(refs):
                bits = ref["bits"] if "bits" in ref else ref["size"].sum()
                for r, out in enumerate(ranks):
                    got = out[(family, i)]
                    torch.testing.assert_close(got["x_hat"], ref["x_hat"].cpu(), rtol=0,
                                               atol=2e-4)
                    torch.testing.assert_close(got["bits"], bits.cpu(), rtol=2e-4, atol=0)
                    warps = got["stats"].warps
                    assert got["launches"] == len(warps)
                    assert len(warps) == {"flexrate": 4, "elic": 0}.get(family, len(warps))
                    assert family == "elic" or warps
                    for w in warps:
                        assert w[0] == rows_of(w[2], 4, r)[0]


# The memory-pressure decodes: (encoding CLI, decoding CLI, coding
# arguments, model arguments both CLIs take) at small widths.
PRESSURE_RUNS = {
    "lhbdc": ("encode_v", "decode_v", ["--synthetic", "9", "--width", "384", "--height", "256",
                                       "--gop", "8", "--level_batched", "--max_batch", "2",
                                       "--compute_dtype", "bfloat16"],
              ["--init", "random", "--N", "32", "--intra_N", "16", "--intra_M", "24",
               "--intra_groups", "4,4,16", "--device", "cuda"]),
    "dmc": ("encode_p", "decode_p", ["--synthetic", "5", "--width", "256", "--height", "256",
                                     "--adaptive"],
            ["--init", "random", "--feat", "16", "--N", "32", "--intra_N", "16",
             "--intra_M", "24", "--intra_groups", "4,4,16", "--device", "cuda"]),
}


@pytest.mark.parametrize("family", list(PRESSURE_RUNS))
def test_decode_under_memory_pressure_is_bit_exact(cuda, family, tmp_path):
    """Encode with the card to itself, decode in a fresh process, then again
    in a fresh process while a ballast process holds all of the card but
    that decoder's peak + the conv-workspace budget + 2 GiB: both decodes
    equal the encoder's frames by sha256, and no allocation failed."""
    import json
    import os
    import subprocess
    import sys

    import chip_smoke
    from tpuvc_torch.ops.precision import CONV_WORKSPACE_GIB

    enc, dec, coding, model = PRESSURE_RUNS[family]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bin_path = str(tmp_path / "x.bin")

    def run(verb, argv):
        proc = subprocess.run([sys.executable, "-c", chip_smoke.DECODE_IN_A_NEW_PROCESS, verb,
                               *argv], cwd=root, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    encoded = run(enc, coding + model + ["--bin", bin_path])
    dec_argv = ["--bin", bin_path, "--out_dir", str(tmp_path / "png"), *model]
    alone = run(dec, dec_argv)
    with chip_smoke.ballast(alone["peak_mem_gib"] + CONV_WORKSPACE_GIB + 2) as held:
        pressed = run(dec, dec_argv)
    assert held > 0
    assert alone["sha256"] == encoded["sha256"]
    assert pressed["sha256"] == encoded["sha256"]
    assert pressed["num_ooms"] == 0


#: Narrow widths of every family for the card's training-determinism runs.
TRAIN_NARROW = {
    "lhbdc": ["model.N=32"],
    "flowguided_b": ["model.N=32", "model.levels=2", "model.feature_channels=(16,32,48)"],
    "deform_b": ["model.N=32", "model.levels=2"],
    "flexrate": ["model.N=32", "model.levels=2"],
    "dmc": ["n_pframes=2"],
    "elic": ["model.N=32", "model.M=320"],
}


@pytest.mark.parametrize("family", list(TRAIN_NARROW))
def test_two_training_runs_are_bit_identical_on_card(cuda, family, tmp_path):
    """The train CLI twice from one seed and one batch stream (batch 2,
    128x128 crops, 2 steps, both stages of the recursive families) under
    its deterministic_training: the same parameter bits (the summary's
    digest), through the kernels' backward."""
    from tpuvc_torch.cli import train

    runs = [train.main(["--device", "cuda", f"model.family={family}", *TRAIN_NARROW[family],
                        "batch_size=2", "crop=128", "total_steps=2", "stage2_start=1",
                        "val_every=100", "workers=0", "prefetch=0",
                        f"dataset_root={tmp_path}/none", f"checkpoint_dir={tmp_path}/{k}"])
            for k in range(2)]
    assert runs[0]["params_sha256"] == runs[1]["params_sha256"]
    assert runs[0]["metrics"] == runs[1]["metrics"]


@pytest.mark.parametrize("kernel, shape", [
    ("warp", (8, 256, 256, 48)), ("warp", (32, 256, 256, 3)),
    ("deform", (8, 128, 128, 128)), ("deform", (8, 128, 128, 32)),
])
def test_kernel_backward_is_deterministic_under_training(cuda, kernel, shape):
    """At the training shapes, under deterministic_training: two backward
    passes of the kernel path give the same bits, and equal the plain
    version's own autograd bit for bit (the backward is autograd of the
    plain formulation in both)."""
    from tpuvc_torch.ops.deform import deform_conv2d, deform_plain
    from tpuvc_torch.ops.precision import deterministic_training
    from tpuvc_torch.ops.warp import warp, warp_plain

    gen = torch.Generator(device=cuda).manual_seed(26)
    B, H, W, C = shape
    if kernel == "warp":
        inputs = (torch.rand(shape, generator=gen, device=cuda),
                  4.0 * torch.randn((B, H, W, 2), generator=gen, device=cuda))
        g = torch.randn(shape, generator=gen, device=cuda)
        fns = (lambda i, f: warp(i, f, "exact"), lambda i, f: warp_plain(i, f, "exact"))
    else:
        G, C_out = (16, 64) if C == 128 else (8, 32)
        inputs = (torch.randn(shape, generator=gen, device=cuda),
                  2.0 * torch.randn((B, H, W, G * 18), generator=gen, device=cuda),
                  torch.rand((B, H, W, G * 9), generator=gen, device=cuda),
                  torch.randn((C_out, C // G, 3, 3), generator=gen, device=cuda) / (9 * C // G),
                  0.1 * torch.randn((C_out,), generator=gen, device=cuda))
        g = torch.randn((B, H, W, C_out), generator=gen, device=cuda)
        fns = (lambda *t: deform_conv2d(*t, G, 3), lambda *t: deform_plain(*t, G, 3))

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*ins), ins, g)

    with deterministic_training(cuda):
        first, second, plain = grads(fns[0]), grads(fns[0]), grads(fns[1])
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(first, plain))


def test_entry_point_refuses_a_card_without_the_budget(cuda):
    """A coder stops before it codes anything where a ballast process
    leaves less than the conv-workspace budget free, naming the GiB."""
    import chip_smoke
    from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder
    from tpuvc_torch.ops.precision import CONV_WORKSPACE_GIB, ConvWorkspaceError

    torch.cuda.empty_cache()
    model = LHBDC(N=16, generator=torch.Generator().manual_seed(0))
    with chip_smoke.ballast(CONV_WORKSPACE_GIB / 2):
        with pytest.raises(ConvWorkspaceError, match=f"needs {CONV_WORKSPACE_GIB} GiB"):
            LHBDCCoder(model, device="cuda")


def _allocate_above_the_budget(cuda, seconds):
    """Allocate, fill and free blocks above the conv-workspace budget for
    ``seconds``, each from fresh memory (the cache emptied after each);
    returns how many."""
    import time

    from tpuvc_torch.ops.precision import CONV_WORKSPACE_GIB

    big = int((CONV_WORKSPACE_GIB + 1) * 2**30)
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        block = torch.empty(big + (n % 3) * 2**21, dtype=torch.uint8, device=cuda)
        block.fill_(1)
        del block
        torch.cuda.empty_cache()
        n += 1
    return n


def _conv_operands(cuda, k):
    gen = torch.Generator(device=cuda).manual_seed(k)
    return (torch.randn((1, 8 + k, 64, 64), generator=gen, device=cuda),
            torch.randn((16, 8 + k, 3, 3), generator=gen, device=cuda))


def test_a_window_waits_for_a_pool_task_that_allocates(cuda):
    """The main thread fixes new conv plans (a window each, the process
    capped at what it holds + the budget) while a pool task allocates
    blocks above the budget from fresh memory: each window waits for the
    task, so neither the task's allocations nor the convs fail."""
    import threading

    import torch.nn.functional as F

    from tpuvc_torch.coder.parallel import CtxPool
    from tpuvc_torch.ops import precision

    precision.set_deterministic(cuda)
    started = threading.Event()

    def allocate():
        started.set()
        return _allocate_above_the_budget(cuda, 2.0)

    pool = CtxPool(max_workers=1)
    try:
        fut = pool.submit(allocate)
        started.wait(10)
        for k in range(8):
            x, w = _conv_operands(cuda, 100 + k)
            assert torch.equal(precision.conv(x, w, padding=1), F.conv2d(x, w, padding=1))
        assert fut.result(timeout=60) > 0
    finally:
        pool.shutdown()


def test_a_pool_task_window_waits_for_its_submitter(cuda):
    """A pool task fixes new conv plans while the thread that submitted it
    (it holds the gate while the task runs) allocates blocks above the
    budget from fresh memory between convs of a fixed plan, then waits on
    the task: the windows open only while that thread is parked, and
    nothing fails."""
    import torch.nn.functional as F

    from tpuvc_torch.coder.parallel import CtxPool
    from tpuvc_torch.ops import precision

    precision.set_deterministic(cuda)
    x0, w0 = _conv_operands(cuda, 200)
    precision.conv(x0, w0, padding=1)

    def convs():
        same = []
        for k in range(8):
            x, w = _conv_operands(cuda, 300 + k)
            same.append(torch.equal(precision.conv(x, w, padding=1),
                                    F.conv2d(x, w, padding=1)))
        return same

    pool = CtxPool(max_workers=1)
    try:
        fut = pool.submit(convs)
        for _ in range(20):
            assert _allocate_above_the_budget(cuda, 0.1) > 0
            precision.conv(x0, w0, padding=1)  # parks while a window waits
        assert all(fut.result(timeout=60))
    finally:
        pool.shutdown()
