"""Import reference (PyTorch/compressai) checkpoints (port of
tpuvc.utils.torch_import).

A user of the reference repo has trained ``.pth`` checkpoints; this module
brings those weights to both packages. It maps the reference's state-dict
key space onto tpuvc's flax parameter tree (HWIO conv kernels) and returns
that tree, numpy only, exactly as tpuvc's importer does: the port then
loads it through its one converter, ``tpuvc_torch.utils.convert.
params_from_jax``, and ``tpuvc_torch.cli.import_torch`` writes it with the
bytes of tpuvc's CLI, so one mapping serves both packages.

Supported: all five checkpoint families (see ``_IMPORTERS``): LHBDC
(whole-model ``{"state_dict": sd}``, the reference's LHBDC/train.py:205-215),
Flex-Rate (per-child dict, Flex-Rate…/test/utils.py save format), ELIC
intra, DeformB (v3) and FlowGuidedB (v4) raw ``model.state_dict()``
(ICIP2023/24). The LHBDC mapping covers module names from
LHBDC/model/m.py:20-29 (FlowNet, mv_compressor, residual_compressor,
masknet), compressai layer internals (conv1/conv2/gdn/skip inside residual
blocks, subpel_conv/upsample in upsample blocks, _matrices/_biases/_factors/
quantiles in the entropy bottleneck), and SPyNet's
``netBasic.{level}.netBasic.{2k}`` conv stack (LHBDC/model/flow.py:48-72).

Layout conversions:
  - ``nn.Conv2d`` weight (O, I, kH, kW) -> flax HWIO (kH, kW, I, O).
  - subpel convs keep torch's (C, r, r) output-channel order — the
    ``pixel_shuffle`` of both packages uses the same convention
    (tpuvc_torch/ops/resample.py).
  - GDN beta/gamma copy verbatim: both sides store sqrt-domain reparam
    values with the same pedestal (2^-18) and bound; gamma is (out, in) in
    both.
  - EntropyBottleneck ``_matrices.{i}`` etc. copy verbatim; the quantized
    CDF buffers are dropped (rebuilt from the parameters).

Entries that cannot be mapped are reported, never silently dropped.
tests/test_torch_reference_import.py holds this module against tpuvc's,
tree for tree and report for report, for every family name.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


class ImportReport:
    """What was consumed and what wasn't."""

    def __init__(self):
        self.used: set[str] = set()
        self.skipped: list[str] = []   # known non-parameters (CDF buffers...)
        self.missing: list[str] = []   # tpuvc slots with no source key

    def unused(self, sd: Mapping[str, Any]) -> list[str]:
        return sorted(k for k in sd if k not in self.used and k not in self.skipped)


def _np(t) -> np.ndarray:
    """torch.Tensor | np.ndarray -> np.ndarray (no torch import required)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


# Buffers rebuilt on the tpuvc side; dropping them is correct, not lossy.
_SKIP_SUFFIXES = (
    "_offset",
    "_quantized_cdf",
    "_cdf_length",
    "target",
    "scale_table",
    ".mask",  # CheckerboardContext mask buffer (ICIP2023/src/model/layers.py:21)
)

# Dead parameters the reference carries but never calls: ELIC and the
# Offset/Res bottlenecks subclass compressai's JointAutoregressiveHierarchical-
# Priors, whose parent __init__ builds a masked-conv `context_prediction`
# (replaced in the subclasses by `context_prediction_models`) — its weights
# sit unused in every checkpoint.
_DEAD_PREFIX_PARTS = ("context_prediction.",)


def _mark_skips(sd, rep: ImportReport) -> None:
    for k in sd:
        if k.endswith(_SKIP_SUFFIXES) or any(
            p in k for p in _DEAD_PREFIX_PARTS
        ):
            rep.skipped.append(k)


def _conv(sd, rep: ImportReport, tkey: str) -> dict:
    w = sd[f"{tkey}.weight"]
    rep.used.add(f"{tkey}.weight")
    out = {"kernel": _np(w).transpose(2, 3, 1, 0)}
    bkey = f"{tkey}.bias"
    if bkey in sd:
        rep.used.add(bkey)
        out["bias"] = _np(sd[bkey])
    else:
        out["bias"] = np.zeros(out["kernel"].shape[-1], np.float32)
    return out


def _gdn(sd, rep: ImportReport, tkey: str) -> dict:
    rep.used.add(f"{tkey}.beta")
    rep.used.add(f"{tkey}.gamma")
    return {
        "beta": _np(sd[f"{tkey}.beta"]),
        "gamma": _np(sd[f"{tkey}.gamma"]).reshape(
            sd[f"{tkey}.beta"].shape[0], -1
        ),
    }


def _res_block(sd, rep, tkey: str, has_skip: bool) -> dict:
    out = {
        "Conv_0": _conv(sd, rep, f"{tkey}.conv1"),
        "Conv_1": _conv(sd, rep, f"{tkey}.conv2"),
    }
    if has_skip:
        out["Conv_2"] = _conv(sd, rep, f"{tkey}.skip")
    return out


def _res_block_stride(sd, rep, tkey: str) -> dict:
    return {
        "Conv_0": _conv(sd, rep, f"{tkey}.conv1"),
        "Conv_1": _conv(sd, rep, f"{tkey}.conv2"),
        "GDN_0": _gdn(sd, rep, f"{tkey}.gdn"),
        "Conv_2": _conv(sd, rep, f"{tkey}.skip"),
    }


def _res_block_upsample(sd, rep, tkey: str) -> dict:
    return {
        "SubpelConv_0": {"Conv_0": _conv(sd, rep, f"{tkey}.subpel_conv.0")},
        "Conv_0": _conv(sd, rep, f"{tkey}.conv"),
        "GDN_0": _gdn(sd, rep, f"{tkey}.igdn"),
        "SubpelConv_1": {"Conv_0": _conv(sd, rep, f"{tkey}.upsample.0")},
    }


def _entropy_bottleneck(sd, rep, tkey: str, filters=(3, 3, 3, 3)) -> dict:
    out = {}
    k = len(filters) + 1
    for i in range(k):
        out[f"matrix_{i}"] = _np(sd[f"{tkey}._matrices.{i}"])
        out[f"bias_{i}"] = _np(sd[f"{tkey}._biases.{i}"])
        rep.used.add(f"{tkey}._matrices.{i}")
        rep.used.add(f"{tkey}._biases.{i}")
        if i < k - 1:
            out[f"factor_{i}"] = _np(sd[f"{tkey}._factors.{i}"])
            rep.used.add(f"{tkey}._factors.{i}")
    out["quantiles"] = _np(sd[f"{tkey}.quantiles"])
    rep.used.add(f"{tkey}.quantiles")
    return out


def _hyperprior(sd, rep, tkey: str, in_subpel_sizes=True) -> dict:
    """MVCompressor / ResidualCompressor (LHBDC/model/layers.py:43-191)."""
    out: dict[str, Any] = {}
    # g_a: (RBS, RB) x3 + conv3x3/s2 — torch Sequential indices 0..6
    for i in range(3):
        out[f"g_a_layers_{2 * i}"] = _res_block_stride(sd, rep, f"{tkey}.g_a.{2 * i}")
        has_skip = f"{tkey}.g_a.{2 * i + 1}.skip.weight" in sd
        out[f"g_a_layers_{2 * i + 1}"] = _res_block(
            sd, rep, f"{tkey}.g_a.{2 * i + 1}", has_skip
        )
    out["g_a_layers_6"] = _conv(sd, rep, f"{tkey}.g_a.6")
    # h_a: convs at Sequential indices 0,2,4,6,8 (LeakyReLU between)
    for j, idx in enumerate((0, 2, 4, 6, 8)):
        out[f"h_a_convs_{j}"] = _conv(sd, rep, f"{tkey}.h_a.{idx}")
    # h_s: conv / subpel / conv / subpel / conv at 0, 2.0, 4, 6.0, 8
    out["h_s_conv0"] = _conv(sd, rep, f"{tkey}.h_s.0")
    out["h_s_up0"] = {"Conv_0": _conv(sd, rep, f"{tkey}.h_s.2.0")}
    out["h_s_conv1"] = _conv(sd, rep, f"{tkey}.h_s.4")
    out["h_s_up1"] = {"Conv_0": _conv(sd, rep, f"{tkey}.h_s.6.0")}
    out["h_s_out"] = _conv(sd, rep, f"{tkey}.h_s.8")
    # g_s: (RB, RBUp) x3 + RB + subpel — indices 0..7
    for i in range(3):
        has_skip = f"{tkey}.g_s.{2 * i}.skip.weight" in sd
        out[f"g_s_layers_{2 * i}"] = _res_block(sd, rep, f"{tkey}.g_s.{2 * i}", has_skip)
        out[f"g_s_layers_{2 * i + 1}"] = _res_block_upsample(
            sd, rep, f"{tkey}.g_s.{2 * i + 1}"
        )
    has_skip = f"{tkey}.g_s.6.skip.weight" in sd
    out["g_s_layers_6"] = _res_block(sd, rep, f"{tkey}.g_s.6", has_skip)
    out["g_s_layers_7"] = {"Conv_0": _conv(sd, rep, f"{tkey}.g_s.7.0")}
    out["entropy_bottleneck"] = _entropy_bottleneck(sd, rep, f"{tkey}.entropy_bottleneck")
    return out


def _spynet(sd, rep, tkey: str, num_levels: int = 6) -> dict:
    out = {}
    for lv in range(num_levels):
        blk = {}
        for k, idx in enumerate((0, 2, 4, 6, 8)):
            c = _conv(sd, rep, f"{tkey}.netBasic.{lv}.netBasic.{idx}")
            blk[f"conv{k}_kernel"] = c["kernel"]
            blk[f"conv{k}_bias"] = c["bias"]
        out[f"basic_{lv}"] = blk
    return out


def _mask_unet(sd, rep, tkey: str) -> dict:
    order = (
        "conv1", "conv2", "conv3", "bottleneck",
        "deconv1", "deconv2", "deconv3", "conv4",
    )
    return {
        f"Conv_{i}": _conv(sd, rep, f"{tkey}.{name}")
        for i, name in enumerate(order)
    }


def import_lhbdc_state_dict(sd: Mapping[str, Any]):
    """Reference LHBDC whole-model state dict -> (flax params, ImportReport).

    Accepts either the raw ``model.state_dict()`` mapping or the
    ``{"state_dict": ...}`` wrapper the reference trainer writes.
    """
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    rep = ImportReport()
    _mark_skips(sd, rep)
    params = {
        "flownet": _spynet(sd, rep, "FlowNet"),
        "mv_compressor": _hyperprior(sd, rep, "mv_compressor"),
        "residual_compressor": _hyperprior(sd, rep, "residual_compressor"),
        "masknet": _mask_unet(sd, rep, "masknet"),
    }
    return params, rep


def _unet(sd, rep, tkey: str, depth: int) -> dict:
    """Flex-Rate UNet (Flex-Rate.../b_model/unet.py:9-95) -> tpuvc UNet.

    tpuvc's @nn.compact call order numbers the convs: down blocks (2 per
    level), midconv, up blocks (up conv + 2 block convs, processed from the
    deepest = torch up_path.0), final conv.
    """
    out = {}
    c = 0

    def put(src):
        nonlocal c
        out[f"Conv_{c}"] = _conv(sd, rep, src)
        c += 1

    for i in range(depth):
        put(f"{tkey}.down_path.{i}.block.0")
        put(f"{tkey}.down_path.{i}.block.2")
    put(f"{tkey}.midconv")
    for j in range(depth - 1):
        put(f"{tkey}.up_path.{j}.up.1")
        put(f"{tkey}.up_path.{j}.conv_block.block.0")
        put(f"{tkey}.up_path.{j}.conv_block.block.2")
    put(f"{tkey}.last")
    return out


def _gain(sd, rep, tkey: str) -> dict:
    rep.used.add(f"{tkey}.gain_matrix")
    return {"gain_matrix": _np(sd[f"{tkey}.gain_matrix"])}


def import_flexrate_state_dict(sd: Mapping[str, Any]):
    """Reference Flex-Rate BidirFlowRef state dict -> (flax params, report).

    Module names from Flex-Rate.../b_model/b_model.py:28-32 (flow_predictor,
    Mask, flow_compressor, residual_compressor); the gained compressors share
    the LHBDC hyperprior transform topology plus 4 gain units each
    (b_model/layers.py:76-246).
    """
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    rep = ImportReport()
    _mark_skips(sd, rep)

    def gained(tkey):
        out = _hyperprior(sd, rep, tkey)
        for g in ("gain_unit", "inv_gain_unit",
                  "hyper_gain_unit", "hyper_inv_gain_unit"):
            out[g] = _gain(sd, rep, f"{tkey}.{g}")
        return out

    params = {
        "flow_predictor": _unet(sd, rep, "flow_predictor", depth=5),
        "mask": _unet(sd, rep, "Mask", depth=4),
        "flow_compressor": gained("flow_compressor"),
        "residual_compressor": gained("residual_compressor"),
    }
    return params, rep


# --- v3/v4 (ICIP2023/ICIP2024) + ELIC intra -------------------------------
#
# Reference module topologies: ELIC ICIP2023/src/model/elic.py:87-202,
# Offset/Res ELIC ICIP2023/src/model/offset_res_elic.py:72-461 and
# ICIP2024/src/model/compression_bottlenecks.py:72-460, helper nets
# ICIP2023/src/model/helpers.py:15-147 / ICIP2024/src/model/helpers.py:35-262,
# whole models ICIP2023/src/model/m.py:19-39 / ICIP2024/src/model/m.py:31-49.


def _deconv(sd, rep: ImportReport, tkey: str) -> dict:
    """torch ConvTranspose2d(padding=k//2, output_padding=s-1) -> tpuvc
    Deconv. Weight (I, O, kH, kW) -> HWIO with a spatial flip; combined with
    Deconv's explicit (k-1-k//2, k-1-k//2+s-1) padding the operator matches
    torch sample-for-sample (validated in tests/test_torch_import_v34.py)."""
    w = _np(sd[f"{tkey}.weight"])
    rep.used.add(f"{tkey}.weight")
    kern = np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])
    bkey = f"{tkey}.bias"
    if bkey in sd:
        rep.used.add(bkey)
        bias = _np(sd[bkey])
    else:
        bias = np.zeros(kern.shape[-1], np.float32)
    return {"ConvTranspose_0": {"kernel": kern, "bias": bias}}


def _rbb(sd, rep, tkey: str) -> dict:
    """ELIC ResidualBottleneckBlock (elic.py:69-84): Sequential indices
    0/2/4 are the 1x1-3x3-1x1 convs."""
    return {
        f"Conv_{j}": _conv(sd, rep, f"{tkey}.BottleneckBlock.{2 * j}")
        for j in range(3)
    }


def _res_unit(sd, rep, tkey: str) -> dict:
    return {
        f"Conv_{j}": _conv(sd, rep, f"{tkey}.conv.{2 * j}") for j in range(3)
    }


def _attention(sd, rep, tkey: str) -> dict:
    """compressai AttentionBlock: conv_a = 3 residual units, conv_b = 3
    residual units + 1x1 conv."""
    out = {}
    for i in range(3):
        out[f"ResidualUnit_{i}"] = _res_unit(sd, rep, f"{tkey}.conv_a.{i}")
    for i in range(3):
        out[f"ResidualUnit_{i + 3}"] = _res_unit(sd, rep, f"{tkey}.conv_b.{i}")
    out["Conv_0"] = _conv(sd, rep, f"{tkey}.conv_b.3")
    return out


def _conv_rbb(sd, rep, tkey: str, blocks: int = 3) -> dict:
    """Sequential(conv, RBB x blocks) -> tpuvc _ConvRBB."""
    out = {"Conv_0": _conv(sd, rep, f"{tkey}.0")}
    for i in range(blocks):
        out[f"ResidualBottleneckBlock_{i}"] = _rbb(sd, rep, f"{tkey}.{i + 1}")
    return out


def _checkerboard(sd, rep, tkey: str) -> dict:
    out = _conv(sd, rep, tkey)
    return {"kernel": out["kernel"], "bias": out["bias"]}


def _triple_conv(sd, rep, tkey: str) -> dict:
    """Sequential(conv, act, conv, act, conv) -> Conv_0..2 (entropy params /
    channel context stacks)."""
    return {
        f"Conv_{j}": _conv(sd, rep, f"{tkey}.{2 * j}") for j in range(3)
    }


def import_elic_state_dict(sd: Mapping[str, Any]):
    """Reference ELIC intra codec state dict -> (flax params, report)."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    rep = ImportReport()
    _mark_skips(sd, rep)

    def seq(tkey, kinds):
        out = {}
        for i, kind in enumerate(kinds):
            src = f"{tkey}.{i}"
            if kind == "conv":
                out[f"{tkey}_layers_{i}"] = _conv(sd, rep, src)
            elif kind == "deconv":
                out[f"{tkey}_layers_{i}"] = _deconv(sd, rep, src)
            elif kind == "rbb":
                out[f"{tkey}_layers_{i}"] = _rbb(sd, rep, src)
            elif kind == "attn":
                out[f"{tkey}_layers_{i}"] = _attention(sd, rep, src)
        return out

    c, r, a, d = "conv", "rbb", "attn", "deconv"
    params = {}
    params.update(seq("g_a", [c, r, r, r, c, r, r, r, a, c, r, r, r, c, a]))
    params.update(seq("g_s", [a, d, r, r, r, d, a, r, r, r, d, r, r, r, d]))
    for j in range(3):
        params[f"h_a_layers_{j}"] = _conv(sd, rep, f"h_a.{2 * j}")
    params["h_s_layers_0"] = _deconv(sd, rep, "h_s.0")
    params["h_s_layers_1"] = _deconv(sd, rep, "h_s.2")
    params["h_s_layers_2"] = _conv(sd, rep, "h_s.4")
    for i in range(5):
        params[f"entropy_parameters_{i}"] = _triple_conv(
            sd, rep, f"entropy_parameters.{i}"
        )
        params[f"context_prediction_models_{i}"] = _checkerboard(
            sd, rep, f"context_prediction_models.{i}"
        )
    for i in range(4):
        params[f"channel_context_models_{i}"] = _triple_conv(
            sd, rep, f"channel_context_models.{i}"
        )
    params["entropy_bottleneck"] = _entropy_bottleneck(
        sd, rep, "entropy_bottleneck"
    )
    return params, rep


def _cond_elic(sd, rep, tkey: str, pixel_stage: bool = False) -> dict:
    """Offset_ELIC / Res_ELIC -> tpuvc CondELIC parameter tree."""
    p: dict[str, Any] = {}
    if pixel_stage:
        p["g_a0"] = _conv_rbb(sd, rep, f"{tkey}.g_a0")
    for i in (1, 2, 3):
        p[f"g_a{i}"] = _conv_rbb(sd, rep, f"{tkey}.g_a{i}")
    for i in range(3):
        p[f"g_s3_blocks_{i}"] = _rbb(sd, rep, f"{tkey}.g_s3.{i}")
    p["g_s3_up"] = _deconv(sd, rep, f"{tkey}.g_s3.3")
    for name in ("g_o1", "g_o2", "g_o3"):
        p[name] = {
            "Conv_0": _conv(sd, rep, f"{tkey}.{name}.0"),
            **{
                f"ResidualBottleneckBlock_{i}": _rbb(
                    sd, rep, f"{tkey}.{name}.{i + 1}"
                )
                for i in range(3)
            },
            "Conv_1": _conv(sd, rep, f"{tkey}.{name}.4"),
        }
    for name in ("g_s1", "g_s2"):
        p[name] = {
            "Conv_0": _conv(sd, rep, f"{tkey}.{name}.0"),
            **{
                f"ResidualBottleneckBlock_{i}": _rbb(
                    sd, rep, f"{tkey}.{name}.{i + 1}"
                )
                for i in range(3)
            },
            "Deconv_0": _deconv(sd, rep, f"{tkey}.{name}.4"),
        }
    for j in range(3):
        p[f"h_a{j + 1}"] = _conv(sd, rep, f"{tkey}.h_a.{2 * j}")
    p["h_s1"] = _deconv(sd, rep, f"{tkey}.h_s.0")
    p["h_s2"] = _deconv(sd, rep, f"{tkey}.h_s.2")
    p["h_s3"] = _conv(sd, rep, f"{tkey}.h_s.4")
    p["prior_fusion_in"] = _conv(sd, rep, f"{tkey}.prior_fusion.0")
    for i in range(3):
        p[f"prior_fusion_blocks_{i}"] = _rbb(
            sd, rep, f"{tkey}.prior_fusion.{i + 1}"
        )
    p["prior_fusion_out"] = _conv(sd, rep, f"{tkey}.prior_fusion.4")
    for i in range(5):
        p[f"entropy_parameters_{i}"] = _triple_conv(
            sd, rep, f"{tkey}.entropy_parameters.{i}"
        )
        p[f"context_prediction_models_{i}"] = _checkerboard(
            sd, rep, f"{tkey}.context_prediction_models.{i}"
        )
    for i in range(4):
        p[f"channel_context_models_{i}"] = _triple_conv(
            sd, rep, f"{tkey}.channel_context_models.{i}"
        )
    for g in ("Gain", "InverseGain", "HyperGain", "InverseHyperGain"):
        p[g] = _np(sd[f"{tkey}.{g}"])
        rep.used.add(f"{tkey}.{g}")
    p["entropy_bottleneck"] = _entropy_bottleneck(
        sd, rep, f"{tkey}.entropy_bottleneck"
    )
    return p


def _deform_weight(sd, rep, tkey: str) -> dict:
    """torchvision DeformConv2d weight (O, I/G, kH, kW) -> tpuvc (kH, kW,
    I/G, O); offsets/masks share torchvision's channel layout already."""
    w = _np(sd[f"{tkey}.weight"])
    rep.used.add(f"{tkey}.weight")
    out = {"weight": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
    bkey = f"{tkey}.bias"
    if bkey in sd:
        rep.used.add(bkey)
        out["bias"] = _np(sd[bkey])
    else:
        out["bias"] = np.zeros(w.shape[0], np.float32)
    return out


def _ms_feature(sd, rep, tkey: str) -> dict:
    return {
        f"_ConvRBB_{i}": _conv_rbb(sd, rep, f"{tkey}.layer{i + 1}")
        for i in range(3)
    }


def _temporal_enc(sd, rep, tkey: str) -> dict:
    return {
        f"_ConvRBB_{i}": _conv_rbb(sd, rep, f"{tkey}.g_a{i + 1}")
        for i in range(3)
    }


def _reconstructor(sd, rep, tkey: str, subpel: bool) -> dict:
    """Reconstuctor layer3->layer1 top-down decoder. v4 ends each stage with
    a subpel conv, v3 with a k=3 deconv; in tpuvc's call order the RBBs
    number 0..8 straight through and the 1x1 fusion convs are Conv_0/Conv_1."""
    p: dict[str, Any] = {}
    rbb = 0
    for stage, layer in enumerate(("layer3", "layer2", "layer1")):
        base = 0
        if stage > 0:
            p[f"Conv_{stage - 1}"] = _conv(sd, rep, f"{tkey}.{layer}.0")
            base = 1
        for _ in range(3):
            p[f"ResidualBottleneckBlock_{rbb}"] = _rbb(
                sd, rep, f"{tkey}.{layer}.{base + (rbb % 3)}"
            )
            rbb += 1
        tail = f"{tkey}.{layer}.{base + 3}"
        if subpel:
            p[f"SubpelConv_{stage}"] = {"Conv_0": _conv(sd, rep, f"{tail}.0")}
        else:
            p[f"Deconv_{stage}"] = _deconv(sd, rep, tail)
    return p


def _flownet(sd, rep, tkey: str) -> dict:
    """FlowNET (ICIP2024/src/model/helpers.py:110-166): 4 down stages then
    4 up stages; tpuvc interleaves the 1x1 fusion convs between up stages
    (same function, Conv_i named in call order)."""
    p: dict[str, Any] = {}
    for i in range(4):
        p[f"_ConvRBB_{i}"] = _conv_rbb(sd, rep, f"{tkey}.down{i}", blocks=2)
    rbb = 0
    for u in range(4):
        base = 0
        if u > 0:
            p[f"Conv_{u - 1}"] = _conv(sd, rep, f"{tkey}.up{u}.0")
            base = 1
        for _ in range(2):
            p[f"ResidualBottleneckBlock_{rbb}"] = _rbb(
                sd, rep, f"{tkey}.up{u}.{base + (rbb % 2)}"
            )
            rbb += 1
        p[f"SubpelConv_{u}"] = {
            "Conv_0": _conv(sd, rep, f"{tkey}.up{u}.{base + 2}.0")
        }
    return p


def import_deform_b_state_dict(sd: Mapping[str, Any]):
    """Reference DeformB (ICIP2023) state dict -> (flax params, report)."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    rep = ImportReport()
    _mark_skips(sd, rep)
    params = {
        "feature_extractor": _ms_feature(sd, rep, "feature_extractor"),
        "offset_temp_encoder": _temporal_enc(sd, rep, "offset_temp_encoder"),
        "offset_compressor": _cond_elic(sd, rep, "offset_compressor"),
        "residual_temp_encoder": _temporal_enc(
            sd, rep, "residual_temp_encoder"
        ),
        "residual_compressor": _cond_elic(
            sd, rep, "residual_compressor", pixel_stage=True
        ),
        "reconstructor": _reconstructor(sd, rep, "reconstructor", subpel=False),
    }
    for lv in (1, 2, 3):
        for r in (1, 2):
            name = f"deconv_l{lv}_{r}"
            params[name] = _deform_weight(sd, rep, name)
    return params, rep


def import_flowguided_state_dict(sd: Mapping[str, Any]):
    """Reference FlowGuidedB (ICIP2024) state dict -> (flax params, report)."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    rep = ImportReport()
    _mark_skips(sd, rep)
    params = {
        "feature_extractor": _ms_feature(sd, rep, "feature_extractor"),
        "flow_estimator": _flownet(sd, rep, "flow_estimator"),
        "offset_temporal_conditioner": _temporal_enc(
            sd, rep, "offset_temporal_conditioner"
        ),
        "offset_compressor": _cond_elic(sd, rep, "offset_compressor"),
        "residue_temporal_conditioner": _temporal_enc(
            sd, rep, "residue_temporal_conditioner"
        ),
        "residual_compressor": _cond_elic(sd, rep, "residual_compressor"),
        "reconstructor": _reconstructor(sd, rep, "reconstructor", subpel=True),
    }
    for lv in (1, 2, 3):
        params[f"offset_diversity_l{lv}"] = {
            "DeformConv_0": _deform_weight(
                sd, rep, f"offset_diversity_l{lv}.fusion"
            )
        }
    return params, rep


_IMPORTERS = {
    "lhbdc": import_lhbdc_state_dict,
    "flexrate": import_flexrate_state_dict,
    "elic": import_elic_state_dict,
    "deform_b": import_deform_b_state_dict,
    "icip2023": import_deform_b_state_dict,
    "flowguided": import_flowguided_state_dict,
    "icip2024": import_flowguided_state_dict,
}


def load_pth(path: str, family: str = "lhbdc"):
    """Load a reference ``.pth`` via torch (CPU) and convert.
    Returns (params, report); ``report.unmapped`` lists any source keys the
    mapping did not consume (should be empty for genuine reference ckpts)."""
    import torch

    sd = torch.load(path, map_location="cpu")
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        flat = sd["state_dict"]
    else:
        flat = sd
    params, report = _IMPORTERS[family](sd)
    report.unmapped = report.unused(flat)
    return params, report


def load_lhbdc_pth(path: str):
    """Load a reference ``compression_{lambda}.pth`` via torch (CPU) and
    convert. Returns (params, report)."""
    return load_pth(path, "lhbdc")
