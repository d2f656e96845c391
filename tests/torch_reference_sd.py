"""Synthetic reference (PyTorch/compressai) state dicts, without JAX.

Each function here returns a numpy state dict with exactly the key space and
tensor shapes of the reference's models (topology from LHBDC/model/
{m,layers,flow}.py, Flex-Rate…/b_model/{b_model,layers,unet}.py, ICIP2023/
src/model/{elic,offset_res_elic,helpers,m}.py and ICIP2024/src/model/
{compression_bottlenecks,helpers,m}.py; compressai's layer internals),
including the buffers and dead parameters an importer must skip. The
values are chosen so a model built from them codes real streams:

- conv weights are 0.1-std normal, damped by ``DAMP`` (undamped, they
  grow ~7x a layer through the deep stacks);
- each entropy bottleneck starts as compressai initialises one: quantiles
  (-10, 0, 10), so its CDF tables cover the latents;
- GDN ``beta`` / ``gamma`` hold compressai's reparametrised initial values;
- the gains (Flex-Rate's, CondELIC's) are positive, near 1.

``tests/test_torch_reference_import.py`` and ``chip_smoke.py`` take their
state dicts from here; the card's machine has no JAX, so nothing here
imports it.
"""

from __future__ import annotations

import numpy as np

DAMP = 0.12
_PED = 2.0 ** -36  # compressai GDN's reparametrisation pedestal


def _rand(rng, *shape):
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


def conv(sd, rng, key, cin, cout, k):
    """nn.Conv2d(cin, cout, k): weight (O, I, kH, kW)."""
    sd[f"{key}.weight"] = DAMP * _rand(rng, cout, cin, k, k)
    sd[f"{key}.bias"] = _rand(rng, cout)


def deconv(sd, rng, key, cin, cout, k):
    """nn.ConvTranspose2d(cin, cout, k): weight (I, O, kH, kW)."""
    sd[f"{key}.weight"] = DAMP * _rand(rng, cin, cout, k, k)
    sd[f"{key}.bias"] = _rand(rng, cout)


def gdn(sd, rng, key, c):
    sd[f"{key}.beta"] = np.sqrt(np.ones(c) + _PED).astype(np.float32)
    sd[f"{key}.gamma"] = (np.sqrt(0.1 * np.eye(c) + _PED)
                          + 0.01 * np.abs(rng.standard_normal((c, c)))).astype(np.float32)


def gains(rng, *shape):
    return np.exp(0.1 * rng.standard_normal(shape)).astype(np.float32)


def entropy_bottleneck(sd, rng, key, c):
    """compressai EntropyBottleneck(c), filters (3, 3, 3, 3), at its
    initialisation plus noise, with the buffers the importer skips."""
    dims = (1, 3, 3, 3, 3, 1)
    scale = 10.0 ** (1 / 5)
    for i in range(5):
        init = np.log(np.expm1(1.0 / scale / dims[i + 1]))
        sd[f"{key}._matrices.{i}"] = (init + _rand(rng, c, dims[i + 1], dims[i])).astype(np.float32)
        sd[f"{key}._biases.{i}"] = rng.uniform(-0.5, 0.5, (c, dims[i + 1], 1)).astype(np.float32)
        if i < 4:
            sd[f"{key}._factors.{i}"] = _rand(rng, c, dims[i + 1], 1)
    sd[f"{key}.quantiles"] = np.tile(np.array([-10.0, 0.0, 10.0], np.float32), (c, 1, 1))
    sd[f"{key}._offset"] = np.zeros(c, np.float32)
    sd[f"{key}._quantized_cdf"] = np.zeros((c, 8), np.int32)
    sd[f"{key}._cdf_length"] = np.zeros(c, np.int32)
    sd[f"{key}.target"] = np.zeros(3, np.float32)


def gaussian_buffers(sd, key):
    sd[f"{key}.scale_table"] = np.zeros(64, np.float32)
    sd[f"{key}._offset"] = np.zeros(1, np.float32)
    sd[f"{key}._quantized_cdf"] = np.zeros((1, 8), np.int32)
    sd[f"{key}._cdf_length"] = np.zeros(1, np.int32)


# --- LHBDC (v1) and Flex-Rate (v2) ----------------------------------------


def _res_block(sd, rng, key, i, o, stride=False):
    conv(sd, rng, f"{key}.conv1", i, o, 3)
    conv(sd, rng, f"{key}.conv2", o, o, 3)
    if stride:
        gdn(sd, rng, f"{key}.gdn", o)
        conv(sd, rng, f"{key}.skip", i, o, 1)


def _res_block_up(sd, rng, key, c):
    conv(sd, rng, f"{key}.subpel_conv.0", c, c * 4, 3)
    conv(sd, rng, f"{key}.conv", c, c, 3)
    gdn(sd, rng, f"{key}.igdn", c)
    conv(sd, rng, f"{key}.upsample.0", c, c * 4, 3)


def _hyperprior(sd, rng, key, n, in_ch, out_ch):
    """MVCompressor / ResidualCompressor (LHBDC/model/layers.py:43-191)."""
    for i, cin in enumerate((in_ch, n, n)):
        _res_block(sd, rng, f"{key}.g_a.{2 * i}", cin, n, stride=True)
        _res_block(sd, rng, f"{key}.g_a.{2 * i + 1}", n, n)
    conv(sd, rng, f"{key}.g_a.6", n, n, 3)
    for idx in (0, 2, 4, 6, 8):
        conv(sd, rng, f"{key}.h_a.{idx}", n, n, 3)
    conv(sd, rng, f"{key}.h_s.0", n, n, 3)
    conv(sd, rng, f"{key}.h_s.2.0", n, n * 4, 3)
    conv(sd, rng, f"{key}.h_s.4", n, n * 3 // 2, 3)
    conv(sd, rng, f"{key}.h_s.6.0", n * 3 // 2, n * 6, 3)
    conv(sd, rng, f"{key}.h_s.8", n * 3 // 2, n * 2, 3)
    for i in range(3):
        _res_block(sd, rng, f"{key}.g_s.{2 * i}", n, n)
        _res_block_up(sd, rng, f"{key}.g_s.{2 * i + 1}", n)
    _res_block(sd, rng, f"{key}.g_s.6", n, n)
    conv(sd, rng, f"{key}.g_s.7.0", n, out_ch * 4, 3)
    entropy_bottleneck(sd, rng, f"{key}.entropy_bottleneck", n)


def lhbdc_sd(rng, n: int = 128) -> dict:
    """The reference LHBDC's ``model.state_dict()`` (SPyNet FlowNet, the
    two hyperprior compressors at width ``n``, the mask UNet)."""
    sd = {}
    chans = [(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)]
    for lv in range(6):
        for k, (ci, co) in zip((0, 2, 4, 6, 8), chans):
            conv(sd, rng, f"FlowNet.netBasic.{lv}.netBasic.{k}", ci, co, 7)
    _hyperprior(sd, rng, "mv_compressor", n, 4, 4)
    _hyperprior(sd, rng, "residual_compressor", n, 3, 3)
    ch = 32
    for name, cin, cout, k in (
        ("conv1", 6, ch, 5), ("conv2", ch, ch * 2, 5), ("conv3", ch * 2, ch * 4, 3),
        ("bottleneck", ch * 4, ch * 4, 3), ("deconv1", ch * 8, ch * 4, 3),
        ("deconv2", ch * 6, ch * 2, 5), ("deconv3", ch * 3, ch, 5), ("conv4", ch, 1, 5),
    ):
        conv(sd, rng, f"masknet.{name}", cin, cout, k)
    return sd


def _unet(sd, rng, key, in_ch, out_ch, depth, wf=5):
    prev = in_ch
    for i in range(depth):
        w = 2 ** (wf + i)
        conv(sd, rng, f"{key}.down_path.{i}.block.0", prev, w, 3)
        conv(sd, rng, f"{key}.down_path.{i}.block.2", w, w, 3)
        prev = w
    conv(sd, rng, f"{key}.midconv", prev, prev, 3)
    for j, i in enumerate(reversed(range(depth - 1))):
        w = 2 ** (wf + i)
        conv(sd, rng, f"{key}.up_path.{j}.up.1", prev, w, 3)
        conv(sd, rng, f"{key}.up_path.{j}.conv_block.block.0", 2 * w, w, 3)
        conv(sd, rng, f"{key}.up_path.{j}.conv_block.block.2", w, w, 3)
        prev = w
    conv(sd, rng, f"{key}.last", prev, out_ch, 3)


def flexrate_sd(rng, n: int = 128, levels: int = 6) -> dict:
    """The reference Flex-Rate BidirFlowRef's state dict."""
    sd = {}
    _unet(sd, rng, "flow_predictor", 6, 4, depth=5)
    _unet(sd, rng, "Mask", 16, 2, depth=4)
    for key, in_ch, out_ch in (("flow_compressor", 19, 4), ("residual_compressor", 3, 3)):
        _hyperprior(sd, rng, key, n, in_ch, out_ch)
        for g in ("gain_unit", "inv_gain_unit", "hyper_gain_unit", "hyper_inv_gain_unit"):
            sd[f"{key}.{g}.gain_matrix"] = gains(rng, levels, n)
    return sd


# --- ELIC intra, DeformB (v3), FlowGuidedB (v4) ---------------------------


def _rbb(sd, rng, key, c):
    conv(sd, rng, f"{key}.BottleneckBlock.0", c, c, 1)
    conv(sd, rng, f"{key}.BottleneckBlock.2", c, c, 3)
    conv(sd, rng, f"{key}.BottleneckBlock.4", c, c, 1)


def _attention(sd, rng, key, c):
    for branch in ("conv_a", "conv_b"):
        for i in range(3):
            conv(sd, rng, f"{key}.{branch}.{i}.conv.0", c, c // 2, 1)
            conv(sd, rng, f"{key}.{branch}.{i}.conv.2", c // 2, c // 2, 3)
            conv(sd, rng, f"{key}.{branch}.{i}.conv.4", c // 2, c, 1)
    conv(sd, rng, f"{key}.conv_b.3", c, c, 1)


def _conv_rbb(sd, rng, key, cin, cout, k=5, blocks=3):
    conv(sd, rng, f"{key}.0", cin, cout, k)
    for i in range(blocks):
        _rbb(sd, rng, f"{key}.{i + 1}", cout)


def _entropy_head(sd, rng, t, M, groups, N):
    """entropy_parameters / checkerboard / channel-context stacks, and the
    dead context_prediction module compressai's parent class builds."""
    for i, g in enumerate(groups):
        conv(sd, rng, f"{t}entropy_parameters.{i}.0", M * 4 if i == 0 else M * 6, M * 10 // 3, 1)
        conv(sd, rng, f"{t}entropy_parameters.{i}.2", M * 10 // 3, M * 8 // 3, 1)
        conv(sd, rng, f"{t}entropy_parameters.{i}.4", M * 8 // 3, 2 * g, 1)
        conv(sd, rng, f"{t}context_prediction_models.{i}", g, M * 2, 5)
        sd[f"{t}context_prediction_models.{i}.mask"] = np.zeros((M * 2, g, 5, 5), np.float32)
    prev = 0
    for i, g in enumerate(groups[:-1]):
        prev += g
        conv(sd, rng, f"{t}channel_context_models.{i}.0", prev, N, 5)
        conv(sd, rng, f"{t}channel_context_models.{i}.2", N, N, 5)
        conv(sd, rng, f"{t}channel_context_models.{i}.4", N, M * 2, 5)
    conv(sd, rng, f"{t}context_prediction", M, 2 * M, 5)
    sd[f"{t}context_prediction.mask"] = np.zeros((2 * M, M, 5, 5), np.float32)


def elic_sd(rng, N: int = 192, M: int = 320, groups=(16, 16, 32, 64, 192)) -> dict:
    """The reference ELIC intra codec's state dict (ICIP2023/src/model/
    elic.py:87-202); the defaults are its published widths."""
    sd = {}
    conv(sd, rng, "g_a.0", 3, N, 5)
    for i in (1, 2, 3, 5, 6, 7, 10, 11, 12):
        _rbb(sd, rng, f"g_a.{i}", N)
    conv(sd, rng, "g_a.4", N, N, 5)
    _attention(sd, rng, "g_a.8", N)
    conv(sd, rng, "g_a.9", N, N, 5)
    conv(sd, rng, "g_a.13", N, M, 5)
    _attention(sd, rng, "g_a.14", M)
    _attention(sd, rng, "g_s.0", M)
    deconv(sd, rng, "g_s.1", M, N, 5)
    for i in (2, 3, 4, 7, 8, 9, 11, 12, 13):
        _rbb(sd, rng, f"g_s.{i}", N)
    deconv(sd, rng, "g_s.5", N, N, 5)
    _attention(sd, rng, "g_s.6", N)
    deconv(sd, rng, "g_s.10", N, N, 5)
    deconv(sd, rng, "g_s.14", N, 3, 5)
    conv(sd, rng, "h_a.0", M, N, 3)
    conv(sd, rng, "h_a.2", N, N, 5)
    conv(sd, rng, "h_a.4", N, N, 5)
    deconv(sd, rng, "h_s.0", N, M, 5)
    deconv(sd, rng, "h_s.2", M, M * 3 // 2, 5)
    conv(sd, rng, "h_s.4", M * 3 // 2, M * 2, 3)
    _entropy_head(sd, rng, "", M, groups, N)
    entropy_bottleneck(sd, rng, "entropy_bottleneck", N)
    gaussian_buffers(sd, "gaussian_conditional")
    return sd


def _cond_elic(sd, rng, t, in_ch, cond_ch, head_ch, N=128, M=128, pixel=False):
    """Offset_ELIC / Res_ELIC (ICIP2023/src/model/offset_res_elic.py:72-461)."""
    if pixel:
        _conv_rbb(sd, rng, f"{t}.g_a0", 3, N)
        _conv_rbb(sd, rng, f"{t}.g_a1", N + in_ch[0], N)
    else:
        _conv_rbb(sd, rng, f"{t}.g_a1", in_ch[0], N)
    _conv_rbb(sd, rng, f"{t}.g_a2", N + in_ch[1], N)
    _conv_rbb(sd, rng, f"{t}.g_a3", N + in_ch[2], M)
    for i in range(3):
        _rbb(sd, rng, f"{t}.g_s3.{i}", M)
    deconv(sd, rng, f"{t}.g_s3.3", M, N, 5)
    for lv in (1, 2, 3):
        conv(sd, rng, f"{t}.g_o{lv}.0", N + cond_ch[lv - 1], N, 3)
        for i in range(3):
            _rbb(sd, rng, f"{t}.g_o{lv}.{i + 1}", N)
        conv(sd, rng, f"{t}.g_o{lv}.4", N, head_ch[lv - 1], 3)
    for lv in (1, 2):
        conv(sd, rng, f"{t}.g_s{lv}.0", N + cond_ch[lv], N, 1)
        for i in range(3):
            _rbb(sd, rng, f"{t}.g_s{lv}.{i + 1}", N)
        deconv(sd, rng, f"{t}.g_s{lv}.4", N, N, 5)
    conv(sd, rng, f"{t}.h_a.0", M, N, 3)
    conv(sd, rng, f"{t}.h_a.2", N, N, 5)
    conv(sd, rng, f"{t}.h_a.4", N, N, 5)
    deconv(sd, rng, f"{t}.h_s.0", N, M, 5)
    deconv(sd, rng, f"{t}.h_s.2", M, M, 5)
    conv(sd, rng, f"{t}.h_s.4", M, M, 3)
    conv(sd, rng, f"{t}.prior_fusion.0", 2 * M, 2 * M, 3)
    for i in range(3):
        _rbb(sd, rng, f"{t}.prior_fusion.{i + 1}", 2 * M)
    conv(sd, rng, f"{t}.prior_fusion.4", 2 * M, 2 * M, 3)
    _entropy_head(sd, rng, f"{t}.", M, (6, 6, 12, 24, M - 48), M)
    for g, width in (("Gain", M), ("InverseGain", M), ("HyperGain", N), ("InverseHyperGain", N)):
        sd[f"{t}.{g}"] = gains(rng, 5, width)
    entropy_bottleneck(sd, rng, f"{t}.entropy_bottleneck", N)
    gaussian_buffers(sd, f"{t}.gaussian_conditional")


def _ms_feature(sd, rng, t, channels):
    cin = 3
    for i, c in enumerate(channels):
        _conv_rbb(sd, rng, f"{t}.layer{i + 1}", cin, c, 3)
        cin = c


def _temporal_enc(sd, rng, t, in_ch, N=128, M=128):
    _conv_rbb(sd, rng, f"{t}.g_a1", in_ch[0], N)
    _conv_rbb(sd, rng, f"{t}.g_a2", N + in_ch[1], N)
    _conv_rbb(sd, rng, f"{t}.g_a3", N + in_ch[2], M)


def _reconstructor(sd, rng, t, channels, subpel):
    c1, c2, c3 = channels

    def tail(key, c, out):
        if subpel:
            conv(sd, rng, f"{key}.0", c, out * 4, 3)
        else:
            deconv(sd, rng, key, c, out, 3)

    for i in range(3):
        _rbb(sd, rng, f"{t}.layer3.{i}", c3)
    tail(f"{t}.layer3.3", c3, c3)
    conv(sd, rng, f"{t}.layer2.0", c3 + c2, c2, 1)
    for i in range(3):
        _rbb(sd, rng, f"{t}.layer2.{i + 1}", c2)
    tail(f"{t}.layer2.4", c2, c2)
    conv(sd, rng, f"{t}.layer1.0", c2 + c1, c1, 1)
    for i in range(3):
        _rbb(sd, rng, f"{t}.layer1.{i + 1}", c1)
    tail(f"{t}.layer1.4", c1, 3)


def _flownet(sd, rng, t):
    cin = 6
    for i, c in enumerate((32, 64, 128, 192)):
        conv(sd, rng, f"{t}.down{i}.0", cin, c, 3)
        _rbb(sd, rng, f"{t}.down{i}.1", c)
        _rbb(sd, rng, f"{t}.down{i}.2", c)
        cin = c
    for u, (c, out) in enumerate(((192, 128), (128, 64), (64, 32), (32, 4))):
        base = 0
        if u > 0:
            conv(sd, rng, f"{t}.up{u}.0", 2 * c, c, 1)
            base = 1
        _rbb(sd, rng, f"{t}.up{u}.{base}", c)
        _rbb(sd, rng, f"{t}.up{u}.{base + 1}", c)
        conv(sd, rng, f"{t}.up{u}.{base + 2}.0", c, out * 4, 3)


def _deform(sd, rng, t, cin, cout, groups, k=3):
    """torchvision DeformConv2d weight (O, I/G, kH, kW)."""
    sd[f"{t}.weight"] = DAMP * _rand(rng, cout, cin // groups, k, k)
    sd[f"{t}.bias"] = _rand(rng, cout)


def deform_b_sd(rng) -> dict:
    """The reference DeformB's (ICIP2023/src/model/m.py:19-39) state dict
    at its published widths."""
    sd = {}
    fc = (32, 64, 96)
    _ms_feature(sd, rng, "feature_extractor", fc)
    _temporal_enc(sd, rng, "offset_temp_encoder", tuple(2 * c for c in fc))
    _cond_elic(sd, rng, "offset_compressor", in_ch=tuple(3 * c for c in fc),
               cond_ch=tuple(2 * c for c in fc), head_ch=(432, 432, 432))
    for lv, c in zip((1, 2, 3), fc):
        _deform(sd, rng, f"deconv_l{lv}_1", c, c, 8)
        _deform(sd, rng, f"deconv_l{lv}_2", c, c, 8)
    _temporal_enc(sd, rng, "residual_temp_encoder", tuple(2 * c for c in fc))
    _cond_elic(sd, rng, "residual_compressor", in_ch=tuple(3 * c for c in fc),
               cond_ch=tuple(2 * c for c in fc), head_ch=tuple(2 * c for c in fc), pixel=True)
    _reconstructor(sd, rng, "reconstructor", tuple(2 * c for c in fc), subpel=False)
    return sd


def flowguided_sd(rng) -> dict:
    """The reference FlowGuidedB's (ICIP2024/src/model/m.py:31-49) state
    dict at its published widths."""
    sd = {}
    fc = (64, 96, 128)
    _ms_feature(sd, rng, "feature_extractor", fc)
    _flownet(sd, rng, "flow_estimator")
    _temporal_enc(sd, rng, "offset_temporal_conditioner", tuple(4 * c for c in fc))
    _cond_elic(sd, rng, "offset_compressor", in_ch=tuple(5 * c for c in fc),
               cond_ch=tuple(4 * c for c in fc), head_ch=(432, 432, 432))
    for lv, c in zip((1, 2, 3), fc):
        _deform(sd, rng, f"offset_diversity_l{lv}.fusion", 2 * c, c, 16)
    _temporal_enc(sd, rng, "residue_temporal_conditioner", fc)
    _cond_elic(sd, rng, "residual_compressor", in_ch=tuple(2 * c for c in fc),
               cond_ch=fc, head_ch=fc)
    _reconstructor(sd, rng, "reconstructor", fc, subpel=True)
    return sd


#: family name (the importer CLI's --family) -> fn(rng, **widths) -> state dict.
STATE_DICTS = {
    "lhbdc": lhbdc_sd,
    "flexrate": flexrate_sd,
    "elic": elic_sd,
    "deform_b": lambda rng, **_: deform_b_sd(rng),
    "icip2023": lambda rng, **_: deform_b_sd(rng),
    "flowguided": lambda rng, **_: flowguided_sd(rng),
    "icip2024": lambda rng, **_: flowguided_sd(rng),
}


def save_pth(path: str, sd: dict, wrap: bool = False) -> None:
    """``torch.save`` the state dict as torch tensors (what a reference
    checkpoint holds), LHBDC's trainer format ``{"state_dict": sd}`` when
    ``wrap``."""
    import torch

    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({"state_dict": tensors} if wrap else tensors, path)
