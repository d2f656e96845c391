"""tpuvc_torch.models.layers against tpuvc.models.layers, and the checkpoint
reader and converter that carry tpuvc's parameters over.

Each layer is initialised by flax, its parameters converted with
``params_from_jax``, and both run the same numpy input on the CPU. Float32
tolerance: 1e-5 absolute on unit-scale activations (summation order of the
convolutions differs between XLA and PyTorch). Under the bfloat16 policy the
two frameworks round at other places, so that check is 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tpuvc.models import layers as jl
from tpuvc.ops import checkerboard as jck
from tpuvc.ops.precision import mixed_precision as j_mixed
from tpuvc_torch.models import layers as tl
from tpuvc_torch.ops import checkerboard as tck
from tpuvc_torch.ops.precision import mixed_precision as t_mixed
from tpuvc_torch.utils.checkpoint import load_checkpoint, unpackb
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(jmod, tmod, x, **kw):
    variables = jmod.init(jax.random.key(0), jnp.asarray(x), **kw)
    variables = jax.tree.map(np.asarray, variables)
    # Move GDN off its init so beta/gamma reach the output.
    if "params" in variables:
        variables = jax.tree.map(
            lambda a: a * (1.0 + 0.1 * _x(a.shape, seed=a.size % 7)), variables
        )
    tmod.load_state_dict(params_from_jax(variables))
    return variables


LAYERS = {
    "conv5": (lambda: jl.Conv(7, kernel=5), lambda: tl.Conv(4, 7, kernel=5), 4),
    "conv3_s2": (lambda: jl.Conv(6, kernel=3, stride=2),
                 lambda: tl.Conv(4, 6, kernel=3, stride=2), 4),
    "conv1": (lambda: jl.Conv(3, kernel=1), lambda: tl.Conv(4, 3, kernel=1), 4),
    "deconv": (lambda: jl.Deconv(5, kernel=5, stride=2),
               lambda: tl.Deconv(4, 5, kernel=5, stride=2), 4),
    "deconv_k3": (lambda: jl.Deconv(5, kernel=3, stride=2),
                  lambda: tl.Deconv(4, 5, kernel=3, stride=2), 4),
    "subpel": (lambda: jl.SubpelConv(3, r=2), lambda: tl.SubpelConv(4, 3, r=2), 4),
    "gdn": (lambda: jl.GDN(), lambda: tl.GDN(8), 8),
    "igdn": (lambda: jl.GDN(inverse=True), lambda: tl.GDN(8, inverse=True), 8),
    "res_block": (lambda: jl.ResidualBlock(8), lambda: tl.ResidualBlock(8, 8), 8),
    "res_block_skip": (lambda: jl.ResidualBlock(8), lambda: tl.ResidualBlock(4, 8), 4),
    "res_block_stride": (lambda: jl.ResidualBlockWithStride(8),
                         lambda: tl.ResidualBlockWithStride(4, 8), 4),
    "res_block_up": (lambda: jl.ResidualBlockUpsample(8),
                     lambda: tl.ResidualBlockUpsample(4, 8), 4),
    "res_bottleneck": (lambda: jl.ResidualBottleneckBlock(8),
                       lambda: tl.ResidualBottleneckBlock(8), 8),
    "checkerboard_conv": (lambda: jck.CheckerboardConv(6, kernel=5),
                          lambda: tck.CheckerboardConv(4, 6, kernel=5), 4),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_tpuvc(name):
    jmk, tmk, cin = LAYERS[name]
    jmod, tmod = jmk(), tmk()
    x = _x((2, 12, 16, cin), seed=1)
    variables = _pair(jmod, tmod, x)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["conv5", "gdn", "res_block_up", "res_bottleneck",
                                  "checkerboard_conv"])
def test_layer_bf16_policy_tracks_tpuvc(name):
    jmk, tmk, cin = LAYERS[name]
    jmod, tmod = jmk(), tmk()
    x = _x((1, 8, 8, cin), seed=2)
    variables = _pair(jmod, tmod, x)
    with j_mixed():
        ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with torch.no_grad(), t_mixed():
        out = tmod(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2, rtol=2e-2)


def test_init_matches_flax_distributions():
    """Seeded init draws flax's lecun_normal (var 1/fan_in, truncated at 2
    sigma) and GDN's constants; a trained model loads weights instead."""
    conv = tl.Conv(64, 64, kernel=3)
    tl.init_weights(conv, torch.Generator().manual_seed(0))
    w = conv.weight.detach()
    assert abs(float(w.std()) - (1 / (64 * 9)) ** 0.5) < 2e-3
    assert float(w.abs().max()) <= 2 * (1 / (64 * 9)) ** 0.5 / 0.8796256 + 1e-6
    gdn = tl.GDN(4)
    ref = jl.GDN().init(jax.random.key(0), jnp.zeros((1, 2, 2, 4)))["params"]
    np.testing.assert_allclose(gdn.beta.detach().numpy(), ref["beta"], rtol=1e-6)
    np.testing.assert_allclose(gdn.gamma.detach().numpy(), ref["gamma"], rtol=1e-6)


def test_checkpoint_reader_reads_flax_msgpack(tmp_path):
    tree = {
        "params": {
            "a": {"kernel": np.arange(24, dtype=np.float32).reshape(2, 3, 4)},
            "b": np.array([1, -2, 3], np.int32),
            "c": {"d": np.float64(2.5), "e": np.zeros((0, 3), np.float16)},
        },
        "step": 9000,
        "name": "x" * 40,
        "flags": [True, None, -70000, 3.25, b"raw"],
    }
    blob = serialization.msgpack_serialize(tree)
    out = unpackb(blob)
    ref = serialization.msgpack_restore(blob)
    flat_o = jax.tree_util.tree_leaves_with_path(out)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_o] == [p for p, _ in flat_r]
    for (_, a), (_, b) in zip(flat_o, flat_r):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    path = tmp_path / "ckpt.msgpack"
    path.write_bytes(blob)
    assert load_checkpoint(str(path))["step"] == 9000


def test_converter_maps_every_lhbdc_parameter():
    """The converted tree of an LHBDC-shaped flax tree fills the port's
    state dict exactly (no missing, no unexpected key, same shapes)."""
    from tpuvc.models.lhbdc import LHBDC as JL
    from tpuvc_torch.models.lhbdc import LHBDC as TL

    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: JL(N=8).init(jax.random.key(0), x, x, x, "dequantize"))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = params_from_jax(tree)
    model = TL(N=8)
    ref = model.state_dict()
    assert sorted(sd) == sorted(ref)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k


def test_converter_maps_every_flowguided_parameter():
    """A converted FlowGuidedB-shaped flax tree (CondELIC's module lists,
    gains, DeformConv weights) loads into the port with strict=True."""
    from tpuvc.models.flowguided_b import FlowGuidedB as JF
    from tpuvc_torch.models.flowguided_b import FlowGuidedB as TF

    kw = dict(feature_channels=(16, 32, 48), N=16, M=16, levels=3, groups=(4, 4, 8))
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(
        lambda: JF(**kw).init(jax.random.key(0), x, x, x, 1, 0.5, -0.5, 1, "dequantize")
    )
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = TF(**kw)
    model.load_state_dict(params_from_jax(tree), strict=True)
    assert model.offset_diversity_l1.DeformConv_0.weight.shape == (16, 2, 3, 3)
