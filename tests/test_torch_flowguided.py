"""tpuvc_torch.models.flowguided_b (the v4 codec) against tpuvc on the CPU,
and the port's own real-bitstream coding.

The forward runs at tests/test_flowguided.py's size (feature channels
(16, 32, 48), N=M=32, 3 levels, groups (4, 4, 8, 16), 64x64 frames) on the
same seeded parameters in both packages (tests/torch_params_common.py,
carried over by ``params_from_jax``). FlowNET's flow head and Offset_ELIC's
offset heads, which flax starts at zero, get seeded values too, so flows
and deform offsets are fractional and nonzero. Bars: x_hat 2e-5 absolute;
bits 1e-6 relative on float64 sums of each package's likelihoods.

Coding round trips (encode -> streams -> decode) must reproduce the
encoder's reconstructions bit for bit, and the streams use tpuvc's
``VFrameBitstream`` byte layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import V4_KW as KW
from torch_params_common import filled_params
from tpuvc.coder.container import VFrameBitstream as JVFrame
from tpuvc.models import flowguided_b as jf
from tpuvc_torch.coder import parallel
from tpuvc_torch.coder.container import VFrameBitstream
from tpuvc_torch.models import flowguided_b as tf
from tpuvc_torch.ops.precision import policy_from_name
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

HEADS = {  # seeded heads: flows of ~1 px, offsets of a few px around them
    "params/flow_estimator/SubpelConv_3": 1.0,
    **{f"params/offset_compressor/g_o{i}/Conv_1": 0.05 for i in (1, 2, 3)},
}


def _frames(shape=(2, 64, 64, 3), seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random(shape, dtype=np.float32)
    drift = 0.04 * rng.standard_normal(shape).astype(np.float32)
    return base, np.clip(base + 0.5 * drift, 0, 1), np.clip(base + drift, 0, 1)


def _bits64(liks):
    return sum(
        float(np.sum(-np.log2(np.maximum(np.asarray(p, np.float64), 1e-9)))) for p in liks
    )


@pytest.mark.parametrize("order,refs", [(4, (0, 8)), (2, (0, 8)), (5, (3, 3)), (1, (0, 3))])
def test_scales_match_tpuvc(order, refs):
    ref = jf.get_scales(order, *refs)
    assert tf.get_scales(order, *refs) == ref
    conv = tf.convert_scales(*ref)
    jconv = jf.convert_scales(*ref)
    assert conv == (float(jconv[0]), float(jconv[1]))


@pytest.fixture(scope="module")
def pair():
    jm = jf.FlowGuidedB(**KW)
    x = jnp.zeros((1, 64, 64, 3))
    v = filled_params(
        lambda: jm.init(jax.random.key(0), x, x, x, 1, 0.5, -0.5, 1, "dequantize"),
        seed=0, scale=HEADS,
    )
    tm = tf.FlowGuidedB(**KW)
    tm.load_state_dict(params_from_jax(v), strict=True)
    return jm, v, tm.eval()


@pytest.mark.parametrize("down_ratio,s", [(1, 1), (2, 1.5)])
def test_flowguided_forward_matches_tpuvc(pair, down_ratio, s):
    jm, v, tm = pair
    x1, xc, x2 = _frames()

    def fwd(v, x1, x2, xc):
        return jm.apply(v, x1, x2, xc, s, 0.5, -0.5, down_ratio, "dequantize",
                        capture_intermediates=True)

    ref, state = jax.jit(fwd)(v, *map(jnp.asarray, (x1, x2, xc)))
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
        getattr(tm, f"offset_diversity_l{i}").DeformConv_0.register_forward_hook(
            lambda mod, args, out: offsets.append(args[1])
        )
        for i in (1, 2, 3)
    ]
    try:
        with torch.no_grad():
            out = tm(*(torch.from_numpy(a) for a in (x1, x2, xc)), s, 0.5, -0.5,
                     down_ratio, "dequantize")
    finally:
        for h in hooks:
            h.remove()

    # The deform convs saw fractional offsets, not integer taps.
    for off in offsets:
        frac = off - torch.floor(off)
        assert float(((frac > 1e-3) & (frac < 1 - 1e-3)).float().mean()) > 0.9
    np.testing.assert_allclose(out["x_hat"].numpy(), np.asarray(ref["x_hat"]), atol=2e-5, rtol=0)
    ref_bits = _bits64(ref_liks)
    assert abs(_bits64(liks) / ref_bits - 1.0) <= 1e-6
    np.testing.assert_allclose(float(out["size"]), float(ref["size"]), rtol=1e-5)
    np.testing.assert_allclose(out["sizes"].numpy(), np.asarray(ref["sizes"]), rtol=1e-5)
    np.testing.assert_allclose(float(out["rate"]), float(ref["rate"]), rtol=1e-5)


def test_flowonly_prediction_matches_tpuvc(pair):
    jm, v, tm = pair
    x1, _, x2 = _frames(seed=1)
    ref = jm.apply(v, jnp.asarray(x1), jnp.asarray(x2), 0.5, -0.5, 2,
                   method=jf.FlowGuidedB.prediction_flowonly)
    with torch.no_grad():
        out = tm.prediction_flowonly(torch.from_numpy(x1), torch.from_numpy(x2), 0.5, -0.5, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_aux_loss_matches_tpuvc(pair):
    jm, v, tm = pair
    ref = float(jm.apply(v, method=jf.FlowGuidedB.aux_loss))
    np.testing.assert_allclose(float(tm.aux_loss().detach()), ref, rtol=1e-5)


def test_vframe_bitstream_bytes_match_tpuvc():
    fields = dict(s_milli=1500, down_ratio=2, scale1_centi=33, scale2_centi=-67,
                  z_shape=(17, 30), streams=[b"z" * 5, b"", b"\x00\xff" * 7, b"abc"])
    blob = VFrameBitstream(**fields).serialize()
    assert blob == JVFrame(**fields).serialize()
    back = VFrameBitstream.deserialize(blob)
    assert back == VFrameBitstream(**fields)
    assert back.num_bytes == len(blob) == JVFrame(**fields).num_bytes


@pytest.fixture(scope="module")
def coder():
    import chip_smoke

    model = chip_smoke.v4_model(torch, N=32, seed=5, feature_channels=(16, 32, 48),
                                levels=3, groups=(4, 4, 8, 16))
    yield tf.FlowGuidedBCoder(model, device="cpu")
    parallel.shutdown()


def _reparse(bits):
    blob = bits.serialize()
    assert JVFrame.deserialize(blob).serialize() == blob  # tpuvc reads it
    return VFrameBitstream.deserialize(blob)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_batch_round_trip_is_bit_exact(coder, dtype):
    x1, xc, x2 = (torch.from_numpy(a) for a in _frames(seed=2))
    with policy_from_name(dtype):
        bits, x_hat = coder.encode_level_batch(x1, x2, xc, 1.0, 0.5, 0.5)
        dec = coder.decode_level_batch(x1, x2, [_reparse(b) for b in bits])
    assert len(bits) == 2 and bits[0].s_milli == 1000 and bits[0].scale1_centi == 50
    assert len(bits[0].streams) == 2 * (1 + 2 * 4)
    assert torch.equal(dec, x_hat)


def test_single_stream_round_trip_is_bit_exact(coder):
    x1, xc, x2 = (torch.from_numpy(a) for a in _frames(seed=3))
    bits, x_hat = coder.encode_recon(x1, x2, xc, 0.5, 0.25, 0.75, down_ratio=2)
    dec = coder.decode(x1, x2, _reparse(bits))
    assert bits.down_ratio == 2 and bits.scale2_centi == 75
    assert torch.equal(dec, x_hat)
    assert coder.encode(x1, x2, xc, 0.5, 0.25, 0.75, 2).serialize() == bits.serialize()


def test_gop_window_round_trip_is_bit_exact(coder):
    """chip_smoke.py's v4 window (bench_torch.bench_window) at a small size:
    2 GOPs of GOP-4 at batch 2, temporal scales per chunk, decoded chunk by
    chunk."""
    import bench_torch

    code_window, decode_window, slot, n_real = bench_torch.bench_window(
        torch, coder, h=64, w=64, gop=4, G=2, B=2, family="flowguided_b"
    )
    with policy_from_name("bfloat16"):
        streams, recon = code_window()
        decoded = decode_window(streams)
    assert n_real == 6 and sorted(streams) == [1, 2, 3, 5, 6, 7]
    for f, x in recon.items():
        assert torch.equal(decoded[f], x), f
        assert torch.isfinite(x).all() and x.shape == slot[f].shape
