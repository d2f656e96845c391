"""tpuvc_torch.models.cond_elic against tpuvc.models.cond_elic on the CPU, and
the port's own CondELICCoder round trips.

Both packages run the same seeded parameters (tests/torch_params_common.py,
carried over by ``params_from_jax``) on the same numpy inputs: a 128x128
frame's /2, /4, /8 conditioning pyramids and its /16 temporal prior, at
N=M=32, 3 rate levels and groups (4, 4, 8, 16). Bars: head outputs 1e-5
absolute; bits 1e-6 relative on float64 sums of each package's likelihoods
(tpuvc's own float32 total carries more rounding than that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import filled_params
from tpuvc.models import cond_elic as jc
from tpuvc_torch.coder import parallel
from tpuvc_torch.models import cond_elic as tc
from tpuvc_torch.models.layers import init_weights
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

N = M = 32
LEVELS = 3
GROUPS = (4, 4, 8, 16)
FC = (8, 16, 24)

# flavour -> (tpuvc module, port module, analysis widths, condition widths, v3 pixel stage)
FLAVOURS = {
    "offset": (
        lambda: jc.OffsetELIC(N=N, M=M, levels=LEVELS, groups=GROUPS),
        lambda: tc.OffsetELIC(tuple(5 * c for c in FC), tuple(4 * c for c in FC), M,
                              N=N, M=M, levels=LEVELS, groups=GROUPS),
        tuple(5 * c for c in FC), tuple(4 * c for c in FC), False,
    ),
    "residual": (
        lambda: jc.ResELIC(N=N, M=M, levels=LEVELS, feature_channels=FC, groups=GROUPS),
        lambda: tc.ResELIC(tuple(2 * c for c in FC), FC, M, N=N, M=M, levels=LEVELS,
                           feature_channels=FC, groups=GROUPS),
        tuple(2 * c for c in FC), FC, False,
    ),
    "v3_flags": (
        lambda: jc.ResELIC(N=N, M=M, levels=LEVELS, feature_channels=FC, groups=GROUPS,
                           pixel_stage=True, ctx_ste=False),
        lambda: tc.ResELIC(tuple(2 * c for c in FC), FC, M, N=N, M=M, levels=LEVELS,
                           feature_channels=FC, groups=GROUPS, pixel_stage=True,
                           ctx_ste=False),
        tuple(2 * c for c in FC), FC, True,
    ),
}


def _inputs(a, k, pixel, B=2, hw=128, seed=0):
    rng = np.random.default_rng(seed)

    def pyr(widths):
        return tuple(
            rng.standard_normal((B, hw // 2 ** (i + 1), hw // 2 ** (i + 1), c)).astype(np.float32)
            for i, c in enumerate(widths)
        )

    temporal = rng.standard_normal((B, hw // 16, hw // 16, M)).astype(np.float32)
    x_pixel = rng.random((B, hw, hw, 3), dtype=np.float32) if pixel else None
    return pyr(a), pyr(k), temporal, x_pixel


def _bits64(liks):
    return sum(
        float(np.sum(-np.log2(np.maximum(np.asarray(p, np.float64), 1e-9)))) for p in liks
    )


@pytest.fixture(scope="module", params=sorted(FLAVOURS))
def pair(request):
    jmk, tmk, a, k, pixel = FLAVOURS[request.param]
    jm = jmk()
    ins, conds, temporal, xp = _inputs(a, k, pixel)
    J = jnp.asarray
    v = filled_params(lambda: jm.init(
        jax.random.key(0), tuple(map(J, ins)), tuple(map(J, conds)), J(temporal), 1,
        "dequantize", None, None if xp is None else J(xp),
    ), seed=1)
    tm = tmk()
    tm.load_state_dict(params_from_jax(v), strict=True)
    return jm, v, tm.eval(), (ins, conds, temporal, xp)


@pytest.mark.parametrize("s", [1, 1.5])
def test_cond_elic_forward_matches_tpuvc(pair, s):
    jm, v, tm, (ins, conds, temporal, xp) = pair
    J = jnp.asarray

    @jax.jit
    def fwd(v, ins, conds, temporal, xp):
        return jm.apply(v, ins, conds, temporal, s, "dequantize", None, xp)

    ref = fwd(v, tuple(map(J, ins)), tuple(map(J, conds)), J(temporal),
              None if xp is None else J(xp))
    T = torch.from_numpy
    with torch.no_grad():
        out = tm(tuple(map(T, ins)), tuple(map(T, conds)), T(temporal), s, "dequantize",
                 x_pixel=None if xp is None else T(xp))
    for key in ("out1", "out2", "out3"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-5,
                                   rtol=0, err_msg=key)
    assert sorted(out["likelihoods"]) == sorted(ref["likelihoods"])
    ref_bits = _bits64(ref["likelihoods"].values())
    assert abs(_bits64(out["likelihoods"].values()) / ref_bits - 1.0) <= 1e-6


@pytest.mark.parametrize("s", [0, 0.5, 1.25, 2, 3.7])
def test_interpolate_gain_matches_tpuvc(pair, s):
    jm, v, tm, _ = pair
    ref = jm.apply(v, s, method=jc.CondELIC.interpolate_gain)
    with torch.no_grad():
        out = tm.interpolate_gain(s)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.fixture(scope="module")
def coder():
    _, tmk, a, k, _ = FLAVOURS["offset"]
    module = init_weights(tmk(), torch.Generator().manual_seed(0)).eval()
    yield tc.CondELICCoder(module), _inputs(a, k, False, seed=2)
    parallel.shutdown()


@pytest.mark.parametrize("s", [0, 1.5])
def test_coder_batch_round_trip_is_bit_exact(coder, s):
    """Per-sample streams at batch 2: decompress_batch reproduces the
    encoder's synthesis bit for bit, and each frame carries its own
    [z, a0, n0, ...] stream list."""
    cc, (ins, conds, temporal, _) = coder
    T = torch.from_numpy
    args = (tuple(map(T, ins)), tuple(map(T, conds)), T(temporal), s)
    enc = cc.compress_batch(*args)
    assert len(enc["streams"]) == 2
    assert all(len(f) == 1 + 2 * len(GROUPS) for f in enc["streams"])
    dec = cc.decompress_batch(enc["streams"], enc["z_shape"], *args[1:])
    for a, b in zip(dec, enc["outs"]):
        assert torch.equal(a, b)


def test_coder_single_stream_round_trip_is_bit_exact(coder):
    cc, (ins, conds, temporal, _) = coder
    T = torch.from_numpy
    args = (tuple(map(T, ins)), tuple(map(T, conds)), T(temporal), 1)
    enc = cc.compress(*args)
    assert len(enc["streams"]) == 1 + 2 * len(GROUPS)
    dec = cc.decompress(enc["streams"], enc["z_shape"], *args[1:], batch=2)
    for a, b in zip(dec, enc["outs"]):
        assert torch.equal(a, b)
