"""tpuvc_torch.models.elic against tpuvc.models.elic on the CPU, the port's
own ELICCoder round trips, and the IFrameBitstream byte layout.

Both packages run the same seeded parameters (tests/torch_params_common.py,
carried over by ``params_from_jax`` into a strict state-dict load) on the
same numpy inputs, at tpuvc's tests/test_elic.py size: N=32, M=48, groups
(4, 4, 8, 32), 64x64 frames. Bars: ResidualUnit and AttentionBlock 1e-5
absolute; ELIC x_hat 2e-5 absolute; group scales and means 1e-5 absolute;
bits 1e-6 relative on float64 sums of each package's likelihoods (tpuvc's
own float32 total carries more rounding than that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import filled_params
from tpuvc.coder.container import IFrameBitstream as JIFrame
from tpuvc.models import elic as je
from tpuvc.models import layers as jl
from tpuvc_torch.coder import parallel
from tpuvc_torch.coder.container import IFrameBitstream
from tpuvc_torch.models import elic as te
from tpuvc_torch.models import layers as tl
from tpuvc_torch.ops.precision import policy_from_name
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

N, M, GROUPS = 32, 48, (4, 4, 8, 32)


def _x(shape, seed=0, uniform=False):
    rng = np.random.default_rng(seed)
    if uniform:
        return rng.random(shape, dtype=np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _bits64(liks):
    return sum(
        float(np.sum(-np.log2(np.maximum(np.asarray(p, np.float64), 1e-9)))) for p in liks
    )


@pytest.mark.parametrize("name", ["residual_unit", "attention_block"])
def test_layer_matches_tpuvc(name):
    jmod, tmod = {
        "residual_unit": (jl.ResidualUnit(16), tl.ResidualUnit(16)),
        "attention_block": (jl.AttentionBlock(16), tl.AttentionBlock(16)),
    }[name]
    x = _x((2, 12, 10, 16))
    v = filled_params(lambda: jmod.init(jax.random.key(0), jnp.asarray(x)), seed=3)
    tmod.load_state_dict(params_from_jax(v), strict=True)
    ref = jmod.apply(v, jnp.asarray(x))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def pair():
    jm = je.ELIC(N=N, M=M, groups=GROUPS)
    x = _x((2, 64, 64, 3), uniform=True)
    v = filled_params(lambda: jm.init(jax.random.key(0), jnp.asarray(x), "dequantize"), seed=1)
    tm = te.ELIC(N=N, M=M, groups=GROUPS)
    tm.load_state_dict(params_from_jax(v), strict=True)
    return jm, v, tm.eval(), x


@pytest.mark.parametrize("stage2", [False, True])
def test_elic_forward_matches_tpuvc(pair, stage2):
    jm, v, tm, x = pair
    ref = jax.jit(lambda v, x: jm.apply(v, x, "dequantize", stage2=stage2))(v, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), "dequantize", stage2=stage2)
    np.testing.assert_allclose(out["x_hat"].numpy(), np.asarray(ref["x_hat"]), atol=2e-5, rtol=0)
    assert sorted(out["likelihoods"]) == sorted(ref["likelihoods"])
    ref_bits = _bits64(ref["likelihoods"].values())
    assert abs(_bits64(out["likelihoods"].values()) / ref_bits - 1.0) <= 1e-6


@pytest.mark.parametrize("i", range(len(GROUPS)))
def test_group_params_match_tpuvc(pair, i):
    jm, v, tm, _ = pair
    h = w = 4
    hyper = _x((2, h, w, 2 * M), seed=10 + i)
    prev = _x((2, h, w, sum(GROUPS[:i])), seed=20 + i)
    anchor = _x((2, h, w, GROUPS[i]), seed=30 + i)
    ref = jm.apply(v, i, jnp.asarray(hyper), jnp.asarray(prev), jnp.asarray(anchor),
                   method=je.ELIC.group_params)
    with torch.no_grad():
        out = tm.group_params(i, *(torch.from_numpy(a) for a in (hyper, prev, anchor)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def coder(pair):
    yield te.ELICCoder(pair[2], device="cpu")
    parallel.shutdown()


def _frames(b, seed=5):
    return torch.from_numpy(_x((b, 64, 64, 3), seed=seed, uniform=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coder_round_trip_is_bit_exact(coder, dtype):
    """One stream set for a batch of 3: decompress equals the encoder's
    synthesis bit for bit, and the stream set survives IFrameBitstream."""
    with policy_from_name(dtype):
        enc = coder.compress(_frames(3))
        blob = IFrameBitstream.from_compress(enc).serialize()
        bits = IFrameBitstream.deserialize(blob)
        assert len(bits.streams) == 2 * len(GROUPS) + 1
        dec = coder.decompress(bits.to_strings(), bits.z_shape, batch=3)
        assert torch.equal(dec, coder.synthesize(enc["y_hat"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coder_batch_round_trip_is_bit_exact(coder, dtype):
    """Per-frame stream sets at batch 3 (encode_v's fresh anchors of a
    2-GOP window): decompress_batch equals the encoder's synthesis."""
    with policy_from_name(dtype):
        enc = coder.compress_batch(_frames(3, seed=6))
        assert len(enc["strings"]) == 3
        assert all(len(y) == 2 * len(GROUPS) for y, _ in enc["strings"])
        dec = coder.decompress_batch(enc["strings"], enc["shape"])
        assert torch.equal(dec, coder.synthesize(enc["y_hat"]))


def test_iframe_bytes_match_tpuvc(coder):
    """The port's IFrameBitstream bytes parse in tpuvc to the same fields,
    and tpuvc serializes those fields to the same bytes."""
    enc = coder.compress(_frames(1, seed=7))
    port = IFrameBitstream.from_compress(enc)
    blob = port.serialize()
    ref = JIFrame.deserialize(blob)
    assert ref.z_shape == port.z_shape and ref.streams == port.streams
    assert JIFrame(z_shape=port.z_shape, streams=port.streams).serialize() == blob
    assert IFrameBitstream.deserialize(ref.serialize()) == port


def test_elic_tree_loads_strictly_from_a_real_init():
    """flax's own init of ELIC (not eval_shape) converts to a state dict
    that loads with strict=True: every leaf has exactly one port key, among
    them the AttentionBlocks g_a_layers_8/_14 and the Deconv h_s_layers."""
    jm = je.ELIC(N=16, M=24, groups=(4, 4, 16))
    v = jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), "dequantize")
    state = params_from_jax(v)
    assert "g_a_layers.8.ResidualUnit_5.Conv_2.weight" in state
    assert "g_a_layers.14.Conv_0.weight" in state
    assert state["h_s_layers.1.weight"].shape == (24, 36, 5, 5)
    tm = te.ELIC(N=16, M=24, groups=(4, 4, 16))
    tm.load_state_dict(state, strict=True)
