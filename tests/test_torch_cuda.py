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
