"""tpuvc_torch.models.flexrate (the Flex-Rate v2 codec), models.unet.UNet and
gop.rate_control against tpuvc on the CPU, and the port's own
real-bitstream coding.

The forward runs at tpuvc's tests/test_flexrate.py size (N=32, 4 gain
levels, 128x128 frames: the flow UNet pools four times and the hyperprior
codes at /64) on the same seeded parameters in both packages
(tests/torch_params_common.py, carried over by ``params_from_jax``), the
gains drawn around 1 so that the levels differ. The flow compressor's last
synthesis conv, which flax starts at zero, is seeded and scaled down with
the residual's (refinements of a few px, residues near the frame's scale),
so the four ``flexrate`` warps sample at fractional positions. Bars: x_hat
2e-5 absolute; bits 1e-6 relative on float64 sums of each package's
likelihoods.

Coding round trips (encode -> streams -> decode) must reproduce the
encoder's reconstructions bit for bit, in tpuvc's ``BFrameBitstream`` byte
layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import filled_params
from tpuvc.coder.container import BFrameBitstream as JBFrame
from tpuvc.gop import rate_control as jrc
from tpuvc.models import flexrate as jf
from tpuvc.models import unet as ju
from tpuvc_torch.coder import parallel
from tpuvc_torch.coder.container import BFrameBitstream
from tpuvc_torch.gop import rate_control as trc
from tpuvc_torch.models import flexrate as tf
from tpuvc_torch.models import unet as tu
from tpuvc_torch.ops.precision import policy_from_name
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

KW = dict(n_levels=4, N=32)
HEADS = {"params/flow_compressor/g_s_layers_7": 0.1,
         "params/residual_compressor/g_s_layers_7": 0.1}


def _frames(shape=(2, 128, 128, 3), seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random(shape, dtype=np.float32)
    drift = 0.04 * rng.standard_normal(shape).astype(np.float32)
    return base, np.clip(base + 0.5 * drift, 0, 1), np.clip(base + drift, 0, 1)


def _bits64(liks):
    return sum(
        float(np.sum(-np.log2(np.maximum(np.asarray(p, np.float64), 1e-9)))) for p in liks
    )


@pytest.mark.parametrize("point", range(len(jrc.FLEXRATE_QUALITIES)))
def test_rate_tables_match_tpuvc(point):
    assert trc.FLEXRATE_QUALITIES[point] == jrc.FLEXRATE_QUALITIES[point]
    for hier in range(1, 7):
        assert trc.flexrate_rate_for_frame(point, hier) == jrc.flexrate_rate_for_frame(point, hier)
    assert trc.LHBDC_POINTS == jrc.LHBDC_POINTS


GAINS = np.exp(0.3 * np.random.default_rng(7).standard_normal((4, 8))).astype(np.float32)
GAINS[1] *= -1.0  # |g| is what counts


@pytest.mark.parametrize("n, l", [
    (0, 1.0), (1, 0.66), (2, 0.33), (3, 0.5),  # level 3 + 1 clips to 3
    ([0, 3], 1.0), ([1, 2], 0.66), ([3, 0], 0.33),  # one level per sample
])
def test_gain_module_matches_tpuvc(n, l):
    x = np.random.default_rng(8).standard_normal((2, 3, 5, 8)).astype(np.float32)
    jg = jf.GainModule(n_levels=4, channels=8)
    ref = jg.apply({"params": {"gain_matrix": jnp.asarray(GAINS)}}, jnp.asarray(x),
                   jnp.asarray(n), l)
    tg = tf.GainModule(n_levels=4, channels=8)
    tg.load_state_dict(params_from_jax({"params": {"gain_matrix": GAINS}}), strict=True)
    tn = torch.tensor(n) if isinstance(n, list) else n
    with torch.no_grad():
        out = tg(torch.from_numpy(x), tn, l)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-6, atol=0)


@pytest.mark.parametrize("cin, out, depth, wf, hw", [(6, 4, 5, 5, 32), (16, 2, 4, 3, 48)])
def test_unet_matches_tpuvc(cin, out, depth, wf, hw):
    """The flow predictor's (depth 5) and a narrow mask-net-like (depth 4)
    UNet; convs named Conv_0.. in flax's creation order."""
    x = np.random.default_rng(9).random((2, hw, hw + 16, cin), dtype=np.float32)
    jm = ju.UNet(out_channels=out, depth=depth, wf=wf)
    v = filled_params(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=2)
    tm = tu.UNet(cin, out_channels=out, depth=depth, wf=wf)
    tm.load_state_dict(params_from_jax(v), strict=True)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        res = tm(torch.from_numpy(x)).numpy()
    assert res.shape == ref.shape == (2, hw, hw + 16, out)
    np.testing.assert_allclose(res, ref, atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def pair():
    jm = jf.BidirFlowRef(**KW)
    x = jnp.zeros((1, 128, 128, 3))
    v = filled_params(lambda: jm.init(jax.random.key(0), x, x, x, 0, 1.0, "dequantize"),
                      seed=0, scale=HEADS)
    tm = tf.BidirFlowRef(**KW)
    tm.load_state_dict(params_from_jax(v), strict=True)
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def jax_forward(pair):
    jm = pair[0]
    return jax.jit(lambda v, xb, xc, xa, n, l: jm.apply(
        v, xb, xc, xa, n, l, "dequantize", capture_intermediates=True))


@pytest.mark.parametrize("n, l", [(2, 0.66), (1, 1.0), (3, 0.33)])
def test_flexrate_forward_matches_tpuvc(pair, jax_forward, n, l):
    jm, v, tm = pair
    xb, xc, xa = _frames()
    ref, state = jax_forward(v, *map(jnp.asarray, (xb, xc, xa)), n, l)
    inter = state["intermediates"]
    ref_liks = [
        p for m in ("flow_compressor", "residual_compressor")
        for p in inter[m]["__call__"][0]["likelihoods"].values()
    ]
    liks, refinement = [], []
    hooks = [
        getattr(tm, m).register_forward_hook(
            lambda mod, args, out: liks.extend(out["likelihoods"].values())
        )
        for m in ("flow_compressor", "residual_compressor")
    ] + [tm.flow_compressor.register_forward_hook(
        lambda mod, args, out: refinement.append(out["x_hat"]))]
    try:
        with torch.no_grad():
            out = tm(*(torch.from_numpy(a) for a in (xb, xc, xa)), n, l, "dequantize")
    finally:
        for h in hooks:
            h.remove()

    # The coded refinement moves the four warps by fractional px.
    (r,) = refinement
    frac = r - torch.floor(r)
    assert float(((frac > 1e-3) & (frac < 1 - 1e-3)).float().mean()) > 0.9
    assert 0.2 < float(r.abs().max()) < 16
    for k in ("x_hat", "x_comp"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=2e-5, rtol=0)
    assert abs(_bits64(liks) / _bits64(ref_liks) - 1.0) <= 1e-6
    np.testing.assert_allclose(out["size"].numpy(), np.asarray(ref["size"]), rtol=1e-5)
    np.testing.assert_allclose(out["rate"].numpy(), np.asarray(ref["rate"]), rtol=1e-5)


def test_process_matches_tpuvc(pair):
    """Flow prediction projected to t=0.5 and both references warped with
    compat='flexrate' (half-pixel shift over a zero ring)."""
    jm, v, tm = pair
    xb, _, xa = _frames(seed=1)
    ref = jm.apply(v, jnp.asarray(xb), jnp.asarray(xa), method=jf.BidirFlowRef.process)
    with torch.no_grad():
        out = tm.process(torch.from_numpy(xb), torch.from_numpy(xa))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5, rtol=0)


def test_aux_loss_matches_tpuvc(pair):
    jm, v, tm = pair
    ref = float(jm.apply(v, method=jf.BidirFlowRef.aux_loss))
    np.testing.assert_allclose(float(tm.aux_loss().detach()), ref, rtol=1e-5)


@pytest.mark.parametrize("n, l", [(0, 1.0), (1, 0.66), (2, 0.33), (5, 0.001), (3, 0.5)])
def test_rate_id_round_trips_as_tpuvc(n, l):
    rid = tf.FlexRateCoder.rate_id(n, l)
    assert rid == n * 100000 + int(round(l * 1000))
    assert tf.FlexRateCoder.parse_rate_id(rid) == jf.FlexRateCoder.parse_rate_id(rid) == (n, l)


@pytest.fixture(scope="module")
def coder():
    import chip_smoke

    model = chip_smoke.flexrate_model(torch, N=32, seed=5, n_levels=4)
    yield tf.FlexRateCoder(model, device="cpu")
    parallel.shutdown()


@pytest.mark.parametrize("batched", [False, True])
def test_gained_hyperprior_coder_round_trip(coder, batched):
    """The residual codec's GainedHyperpriorCoder at (n, l) = (2, 0.33):
    one stream pair for the batch (compress -> decompress, synthesised) or
    one per sample (compress_batch -> decompress_batch, the latent)."""
    hc = coder.res_coder
    x = torch.from_numpy(_frames(seed=4)[0] - 0.5)
    if batched:
        enc = hc.compress_batch(x, 2, 0.33)
        assert len(enc["strings"]) == 2
        assert torch.equal(hc.decompress_batch(enc["strings"], enc["shape"], 2, 0.33),
                           enc["y_hat"])
    else:
        enc = hc.compress(x, 2, 0.33)
        dec = hc.decompress(enc["strings"], enc["shape"], 2, 0.33, batch=2)
        assert torch.equal(dec, hc.synthesize(enc["y_hat"], 2, 0.33))


def _reparse(bits):
    blob = bits.serialize()
    assert JBFrame.deserialize(blob).serialize() == blob  # tpuvc reads it
    return BFrameBitstream.deserialize(blob)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_batch_round_trip_is_bit_exact(coder, dtype):
    xb, xc, xa = (torch.from_numpy(a) for a in _frames(seed=2))
    with policy_from_name(dtype):
        bits, x_hat = coder.encode_level_batch(xb, xc, xa, 2, 0.66)
        parsed = [_reparse(b) for b in bits]
        dec = coder.decode_level_batch(xb, xa, parsed)
        dec_async = coder.decode_level_batch_async(parsed)(xb, xa)
    assert len(bits) == 2 and bits[0].rate_id == 200660
    assert bits[0].mv_shape == bits[0].res_shape == (2, 2)
    assert torch.equal(dec, x_hat) and torch.equal(dec_async, x_hat)


def test_single_stream_round_trip_is_bit_exact(coder):
    import chip_smoke

    xb, xc, xa = (torch.from_numpy(a) for a in _frames(seed=3))
    spread = {}
    hooks = chip_smoke.spread_hooks(torch, coder.model, spread)
    try:
        bits, x_hat = coder.encode_recon(xb, xc, xa, 1, 1.0)
    finally:
        for h in hooks:
            h.remove()
    chip_smoke.check_spread(spread, "flexrate encode_recon", "flexrate")
    dec = coder.decode(xb, xa, _reparse(bits))
    assert bits.rate_id == 101000
    assert torch.equal(dec, x_hat)
    assert coder.encode(xb, xc, xa, 1, 1.0).serialize() == bits.serialize()


def test_gop_window_round_trip_is_bit_exact(coder):
    """chip_smoke.py's Flex-Rate window (bench_torch.bench_window) at a
    small size: 2 GOPs of GOP-4 at batch 2, each level's streams submitted
    ahead of its references."""
    import bench_torch

    code_window, decode_window, slot, n_real = bench_torch.bench_window(
        torch, coder, h=128, w=128, gop=4, G=2, B=2, family="flexrate"
    )
    with policy_from_name("bfloat16"):
        streams, recon = code_window()
        decoded = decode_window(streams)
    assert n_real == 6 and sorted(streams) == [1, 2, 3, 5, 6, 7]
    for f, x in recon.items():
        assert torch.equal(decoded[f], x), f
        assert torch.isfinite(x).all() and x.shape == slot[f].shape
