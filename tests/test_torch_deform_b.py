"""tpuvc_torch.models.deform_b (the v3 codec) against tpuvc on the CPU, and
the port's own real-bitstream coding.

The forward runs at tpuvc's own small DeformB (tests/test_deform_b.py:
feature channels (8, 16, 24), N=M=32, 3 levels, groups (4, 4, 8, 16),
64x64 frames) on the same seeded parameters in both packages
(tests/torch_params_common.py, carried over by ``params_from_jax``).
Offset_ELIC's offset heads, which flax starts at zero, get seeded values
too, so offsets are fractional and masks vary. Bars: x_hat 2e-5 absolute;
bits 1e-6 relative on float64 sums of each package's likelihoods. On the
CPU the port's deform convs run ``deform_plain``, held here also against
torchvision's semantics (tests/refshim's independent oracle) at v3's group
layout.

Coding round trips (encode -> streams -> decode) must reproduce the
encoder's reconstructions bit for bit, in tpuvc's ``VFrameBitstream`` byte
layout.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import filled_params
from tpuvc.coder.container import VFrameBitstream as JVFrame
from tpuvc.models import deform_b as jd
from tpuvc.models import ms_feature as jms
from tpuvc_torch.coder import parallel
from tpuvc_torch.coder.container import VFrameBitstream
from tpuvc_torch.models import deform_b as td
from tpuvc_torch.models import ms_feature as tms
from tpuvc_torch.ops.deform import deform_plain
from tpuvc_torch.ops.precision import policy_from_name
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

KW = dict(feature_channels=(8, 16, 24), N=32, M=32, levels=3, groups=(4, 4, 8, 16))
HEADS = {f"params/offset_compressor/g_o{i}/Conv_1": 1.0 for i in (1, 2, 3)}


def _frames(shape=(2, 64, 64, 3), seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random(shape, dtype=np.float32)
    drift = 0.04 * rng.standard_normal(shape).astype(np.float32)
    return base, np.clip(base + 0.5 * drift, 0, 1), np.clip(base + drift, 0, 1)


def _bits64(liks):
    return sum(
        float(np.sum(-np.log2(np.maximum(np.asarray(p, np.float64), 1e-9)))) for p in liks
    )


@pytest.fixture(scope="module")
def pair():
    jm = jd.DeformB(**KW)
    x = jnp.zeros((1, 64, 64, 3))
    v = filled_params(lambda: jm.init(jax.random.key(0), x, x, x, 1, "dequantize"),
                      seed=0, scale=HEADS)
    tm = td.DeformB(**KW)
    tm.load_state_dict(params_from_jax(v), strict=True)
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def jax_forward(pair):
    jm = pair[0]
    return jax.jit(lambda v, x1, x2, xc, s: jm.apply(
        v, x1, x2, xc, s, "dequantize", capture_intermediates=True))


@pytest.mark.parametrize("s", [1.0, 1.5])
def test_deformb_forward_matches_tpuvc(pair, jax_forward, s):
    jm, v, tm = pair
    x1, xc, x2 = _frames()
    ref, state = jax_forward(v, *map(jnp.asarray, (x1, x2, xc)), s)
    inter = state["intermediates"]
    ref_liks = [
        l for m in ("offset_compressor", "residual_compressor")
        for l in inter[m]["__call__"][0]["likelihoods"].values()
    ]
    liks, offsets = [], []
    hooks = [
        getattr(tm, m).register_forward_hook(
            lambda mod, args, out: liks.extend(out["likelihoods"].values())
        )
        for m in ("offset_compressor", "residual_compressor")
    ] + [
        getattr(tm, f"deconv_l{i}_{r}").register_forward_hook(
            lambda mod, args, out: offsets.append(args[1])
        )
        for i in (1, 2, 3) for r in (1, 2)
    ]
    try:
        with torch.no_grad():
            out = tm(*(torch.from_numpy(a) for a in (x1, x2, xc)), s, "dequantize")
    finally:
        for h in hooks:
            h.remove()

    # All six deform convs saw fractional offsets of up to a few px.
    assert len(offsets) == 6
    for off in offsets:
        frac = off - torch.floor(off)
        assert float(((frac > 1e-3) & (frac < 1 - 1e-3)).float().mean()) > 0.9
        assert 0.2 < float(off.std()) and float(off.abs().max()) < 16
    np.testing.assert_allclose(out["x_hat"].numpy(), np.asarray(ref["x_hat"]), atol=2e-5, rtol=0)
    assert abs(_bits64(liks) / _bits64(ref_liks) - 1.0) <= 1e-6
    np.testing.assert_allclose(float(out["size"]), float(ref["size"]), rtol=1e-5)
    np.testing.assert_allclose(out["sizes"].numpy(), np.asarray(ref["sizes"]), rtol=1e-5)
    np.testing.assert_allclose(float(out["rate"]), float(ref["rate"]), rtol=1e-5)


def test_noise_mode_runs_and_is_seeded(pair):
    _, _, tm = pair
    x1, xc, x2 = (torch.from_numpy(a) for a in _frames(seed=6))
    outs = []
    for _ in range(2):
        with torch.no_grad():
            outs.append(tm(x1, x2, xc, 0.5, "noise", generator=torch.Generator().manual_seed(3)))
    assert torch.isfinite(outs[0]["rate"]) and float(outs[0]["rate"]) > 0
    assert torch.equal(outs[0]["x_hat"], outs[1]["x_hat"])


def test_aux_loss_matches_tpuvc(pair):
    jm, v, tm = pair
    ref = float(jm.apply(v, method=jd.DeformB.aux_loss))
    np.testing.assert_allclose(float(tm.aux_loss().detach()), ref, rtol=1e-5)


def test_reconstructor_deconv_matches_tpuvc():
    """The v3 reconstructor: three RBBs a scale, kernel-3 stride-2
    transposed convs, flax's compact names (ResidualBottleneckBlock_0..8,
    Deconv_0..2, Conv_0..1)."""
    ch = (16, 32, 48)
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((2, 64 // 2**i, 48 // 2**i, c)).astype(np.float32)
          for i, c in enumerate(ch)]
    jm = jms.ReconstructorDeconv(channels=ch)
    v = filled_params(lambda: jm.init(jax.random.key(0), *map(jnp.asarray, xs)), seed=1)
    tm = tms.ReconstructorDeconv(channels=ch)
    tm.load_state_dict(params_from_jax(v), strict=True)
    assert sorted(v["params"]) == sorted(
        [f"ResidualBottleneckBlock_{i}" for i in range(9)]
        + [f"Deconv_{i}" for i in range(3)] + ["Conv_0", "Conv_1"])
    ref = np.asarray(jm.apply(v, *map(jnp.asarray, xs)))
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, xs)).numpy()
    assert out.shape == ref.shape == (2, 128, 96, 3)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_head_to_deform_and_deform_pair_match_tpuvc(pair):
    """One scale (L1): the 432-channel head split into both references'
    144 offsets and 72 sigmoid masks, each reference aligned by its own
    8-group deform conv, the two maps side by side."""
    jm, v, tm = pair
    rng = np.random.default_rng(3)
    head = rng.standard_normal((2, 32, 32, 432)).astype(np.float32)
    f1, f2 = (rng.standard_normal((2, 32, 32, 8)).astype(np.float32) for _ in range(2))
    off, m = td._head_to_deform(torch.from_numpy(head[..., :216]))
    joff, jmask = jd._head_to_deform(jnp.asarray(head[..., :216]))
    assert torch.equal(off, torch.from_numpy(np.array(joff)))
    np.testing.assert_allclose(m.numpy(), np.asarray(jmask), atol=1e-6, rtol=0)  # 1 ulp
    ref = jm.apply(v, *map(jnp.asarray, (head, f1, f2)), method=lambda mod, h, a, b: (
        mod._deform_pair(h, a, b, mod.deconv_l1_1, mod.deconv_l1_2)))
    with torch.no_grad():
        out = tm._deform_pair(*map(torch.from_numpy, (head, f1, f2)), 1)
    assert out.shape == (2, 32, 32, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def _torchvision_oracle():
    path = os.path.join(os.path.dirname(__file__), "refshim", "torchvision", "ops",
                        "deform_conv.py")
    spec = importlib.util.spec_from_file_location("refshim_deform_conv", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.deform_conv2d


@pytest.mark.parametrize("C", [32, 64, 96])
def test_v3_deform_layout_matches_torchvision_semantics(C):
    """deform_plain at v3's layout (8 groups over C channels, C outputs, 3x3
    taps, offsets of a few px that leave the frame) against the refshim
    oracle, which follows torchvision's NCHW deform_conv2d."""
    G, H, W = 8, 12, 20
    rng = np.random.default_rng(C)
    x = rng.standard_normal((1, H, W, C)).astype(np.float32)
    off = (3.0 * rng.standard_normal((1, H, W, G * 18))).astype(np.float32)
    masks = rng.random((1, H, W, G * 9), dtype=np.float32)
    weight = (rng.standard_normal((C, C // G, 3, 3)) / np.sqrt(9 * C / G)).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    x, off, masks, weight, bias = map(torch.from_numpy, (x, off, masks, weight, bias))
    out = deform_plain(x, off, masks, weight, bias, G)
    ref = _torchvision_oracle()(
        x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), weight, bias, padding=(1, 1),
        mask=masks.permute(0, 3, 1, 2),
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=0)


def test_vframe_stream_split_matches_tpuvc():
    """DeformB's streams: the offset coder's 1 + 2 * len(groups), then the
    residual coder's, in tpuvc's header (down ratio 1, both scales 0)."""
    bits = td.DeformBCoder._header(1.5, (4, 4), [b"z", b"a", b"n"])
    blob = bits.serialize()
    assert blob == JVFrame(s_milli=1500, down_ratio=1, scale1_centi=0, scale2_centi=0,
                           z_shape=(4, 4), streams=[b"z", b"a", b"n"]).serialize()


@pytest.fixture(scope="module")
def coder():
    import chip_smoke

    model = chip_smoke.v3_model(torch, N=32, seed=5, feature_channels=(8, 16, 24),
                                levels=3, groups=(4, 4, 8, 16))
    yield td.DeformBCoder(model, device="cpu")
    parallel.shutdown()


def _reparse(bits):
    blob = bits.serialize()
    assert JVFrame.deserialize(blob).serialize() == blob  # tpuvc reads it
    return VFrameBitstream.deserialize(blob)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_batch_round_trip_is_bit_exact(coder, dtype):
    x1, xc, x2 = (torch.from_numpy(a) for a in _frames(seed=2))
    with policy_from_name(dtype):
        bits, x_hat = coder.encode_level_batch(x1, x2, xc, 1.0)
        dec = coder.decode_level_batch(x1, x2, [_reparse(b) for b in bits])
    assert len(bits) == 2 and bits[0].s_milli == 1000 and bits[0].down_ratio == 1
    assert (bits[0].scale1_centi, bits[0].scale2_centi) == (0, 0)
    assert len(bits[0].streams) == 2 * (1 + 2 * 4)
    assert torch.equal(dec, x_hat)


def test_single_stream_round_trip_is_bit_exact(coder):
    x1, xc, x2 = (torch.from_numpy(a) for a in _frames(seed=3))
    spread = {}
    import chip_smoke

    hooks = chip_smoke.spread_hooks(torch, coder.model, spread)
    try:
        bits, x_hat = coder.encode_recon(x1, x2, xc, 0.5)
    finally:
        for h in hooks:
            h.remove()
    chip_smoke.check_spread(spread, "v3 encode_recon", "deform_b")
    dec = coder.decode(x1, x2, _reparse(bits))
    assert bits.s_milli == 500
    assert torch.equal(dec, x_hat)
    assert coder.encode(x1, x2, xc, 0.5).serialize() == bits.serialize()


def test_gop_window_round_trip_is_bit_exact(coder):
    """chip_smoke.py's v3 window (bench_torch.bench_window) at a small size:
    2 GOPs of GOP-4 at batch 2, decoded chunk by chunk."""
    import bench_torch

    code_window, decode_window, slot, n_real = bench_torch.bench_window(
        torch, coder, h=64, w=64, gop=4, G=2, B=2, family="deform_b"
    )
    with policy_from_name("bfloat16"):
        streams, recon = code_window()
        decoded = decode_window(streams)
    assert n_real == 6 and sorted(streams) == [1, 2, 3, 5, 6, 7]
    for f, x in recon.items():
        assert torch.equal(decoded[f], x), f
        assert torch.isfinite(x).all() and x.shape == slot[f].shape


#: The stage spans of a traced DeformB coding call: the model's own stages
#: and those of its parts (CondELIC's, MSFeature's, TemporalEnc's, the
#: reconstructor's).
V3_STAGES = {
    "stage.decoder_context", "stage.feature_extractor.forward",
    "stage.offset_temp_encoder.forward", "stage.fuse_offsets", "stage.residual_cond",
    "stage.residual_temp_encoder.forward", "stage.reconstruct", "stage.reconstructor.forward",
    *(f"stage.{c}.{m}" for c in ("offset_compressor", "residual_compressor")
      for m in ("analysis", "hyper_params", "group_params", "synthesis")),
}


def test_traced_coding_calls_open_the_stage_spans(coder):
    from tpuvc_torch import obs

    x1, xc, x2 = (torch.from_numpy(a) for a in _frames(seed=4))
    obs.reset()
    obs.enable()
    try:
        bits, _ = coder.encode_level_batch(x1, x2, xc, 1.5)
        coder.decode_level_batch(x1, x2, bits)
    finally:
        obs.disable()
    names = [r.name for r in obs.records()]
    obs.reset()
    assert V3_STAGES <= set(names), sorted(V3_STAGES - set(names))
    # both coders' entropy parameters: 5 groups x 2 phases, encode and decode
    assert names.count("stage.offset_compressor.group_params") == 2 * 2 * len(coder.model.groups)
    # off, nothing is recorded
    coder.encode_level_batch(x1, x2, xc, 1.5)
    assert obs.records() == []


@pytest.mark.parametrize("Cg,Og,aligned,per_lane", [
    (4, 4, True, 4), (8, 8, True, 4), (12, 12, True, 4),  # v3's three levels
    (8, 4, True, 2), (12, 6, True, 2), (16, 8, True, 2),  # v4's
    (4, 4, False, 1), (5, 11, True, 3), (64, 128, True, 8), (12, 128, False, 11),
])
def test_outputs_per_lane_follow_the_kernel_s_rule(Cg, Og, aligned, per_lane):
    """csrc/deform.cu: float4 lanes where the group width divides by 4 and
    x is 16-byte aligned, else one channel a lane; a group's outputs over
    its lanes, above 2 the <V, MAXO> instance."""
    from tpuvc_torch.ops.deform import outputs_per_lane

    assert outputs_per_lane(Cg, Og, 4096 if aligned else 4100) == per_lane
