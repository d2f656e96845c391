"""FlowGuidedB, the v4 B-frame codec (port of tpuvc.models.flowguided_b).

1. FlowNET estimates a bidirectional flow pair between the references at a
   chosen ``down_ratio``.
2. The flows are scaled by temporal-distance ratios (``get_scales``,
   ``convert_scales``) to point from the current frame to each reference.
3. A 3-scale feature pyramid of both references is warped by the flow
   pyramid (the flow halved per scale).
4. Offset_ELIC codes deformable-alignment offsets conditioned on [warped refs
   | raw refs | current] features; OffsetDiversity fuses both references per
   scale through the deformable conv (tpuvc_torch.ops.deform).
5. Res_ELIC codes feature-space residues; the Reconstructor decodes RGB.

tpuvc orders its Pallas calls with ``sequenced`` and optimisation barriers
against a TPU scheduling hazard; kernels on one CUDA stream run in issue
order, so the port has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpuvc_torch import obs
from tpuvc_torch.coder.container import VFrameBitstream
from tpuvc_torch.entropy.emath import likelihood_to_bits, per_sample_bits
from tpuvc_torch.models.bframe_coder import CondPairCoder
from tpuvc_torch.models.cond_elic import OffsetELIC, ResELIC
from tpuvc_torch.models.layers import init_weights
from tpuvc_torch.models.ms_feature import FlowNET, MSFeature, Reconstructor, TemporalEnc
from tpuvc_torch.models.offset_diversity import OffsetDiversity
from tpuvc_torch.ops.pad import pad_to_multiple, unpad
from tpuvc_torch.ops.resample import avg_pool2d, bilinear_resize
from tpuvc_torch.ops.warp import warp


def convert_scales(scale1, scale2):
    """Temporal scales rounded to 2 decimals, as float32 host scalars."""
    hundred = np.float32(100.0)

    def rnd(s):
        return float(np.round(np.float32(s) * hundred) / hundred)

    return rnd(scale1), rnd(scale2)


def get_scales(order, order1, order2):
    """Temporal-distance flow scales: the flow is estimated ref1 -> ref2, and
    the frame at ``order`` needs flow_cur->ref1 = flow21 * (order - order1)
    / (order2 - order1), and symmetrically for ref2."""
    if order2 == order1:
        return 0.0, 0.0
    return (
        (order - order1) / (order2 - order1),
        (order - order2) / (order1 - order2),
    )


class FlowGuidedB(nn.Module):
    """``generator`` draws the initial weights (tpuvc's initialisers); a
    trained model loads a state dict instead (tpuvc_torch.utils.convert)."""

    def __init__(self, feature_channels: tuple[int, int, int] = (64, 96, 128),
                 N: int = 128, M: int = 128, levels: int = 5,
                 groups: tuple[int, ...] = (6, 6, 12, 24, 80),
                 generator: torch.Generator | None = None):
        super().__init__()
        fc = tuple(feature_channels)
        self.feature_channels, self.N, self.M = fc, N, M
        self.levels, self.groups = levels, tuple(groups)
        self.feature_extractor = MSFeature(channels=fc)
        self.flow_estimator = FlowNET()
        self.offset_temporal_conditioner = TemporalEnc(tuple(4 * c for c in fc), N=N, M=M)
        self.offset_compressor = OffsetELIC(
            tuple(5 * c for c in fc), tuple(4 * c for c in fc), M,
            N=N, M=M, levels=levels, groups=self.groups,
        )
        self.offset_diversity_l3 = OffsetDiversity(fc[2], magnitude=10.0)
        self.offset_diversity_l2 = OffsetDiversity(fc[1], magnitude=20.0)
        self.offset_diversity_l1 = OffsetDiversity(fc[0], magnitude=40.0)
        self.residue_temporal_conditioner = TemporalEnc(fc, N=N, M=M)
        self.residual_compressor = ResELIC(
            tuple(2 * c for c in fc), fc, M, N=N, M=M, levels=levels,
            feature_channels=fc, groups=self.groups,
        )
        self.reconstructor = Reconstructor(channels=fc)
        if generator is not None:
            init_weights(self, generator)
        obs.name_stages(self)

    def estimate_flow(self, xref1, xref2, down_ratio: int):
        """FlowNET at /(2 * down_ratio) -> 4-channel flow pair at /2 of the
        frame: references pooled, zero-padded to x16, the flow cropped back
        and, for down_ratio > 1, upsampled with its magnitude scaled."""
        d1 = avg_pool2d(xref1, down_ratio * 2)
        d2 = avg_pool2d(xref2, down_ratio * 2)
        h, w = d1.shape[-3], d1.shape[-2]
        d1, _ = pad_to_multiple(d1, 16, mode="constant")
        d2, _ = pad_to_multiple(d2, 16, mode="constant")
        flow = unpad(self.flow_estimator(torch.cat([d1, d2], dim=-1)), (h, w))
        if down_ratio > 1:
            flow = bilinear_resize(flow, h * down_ratio, w * down_ratio) * down_ratio
        return flow

    @obs.stage
    def warped_refs_at_layer(self, fref1, fref2, flow, scale1, scale2):
        """Scale and warp one pyramid level; return the halved flow for the
        next."""
        flow_21, flow_12 = torch.chunk(flow, 2, dim=-1)
        flow_cur1 = flow_21 * scale1
        flow_cur2 = flow_12 * scale2
        wref1 = warp(fref1, flow_cur1)
        wref2 = warp(fref2, flow_cur2)
        h, w = flow.shape[-3] // 2, flow.shape[-2] // 2
        down_flow = bilinear_resize(flow, h, w) * 0.5
        return flow_cur1, flow_cur2, wref1, wref2, down_flow

    def decoder_context(self, xref1, xref2, scale1, scale2, down_ratio: int):
        """Everything the decoder computes from the references: conditioning
        pyramids, temporal prior, per-scale scaled flows, ref features."""
        scale1, scale2 = convert_scales(scale1, scale2)
        flow = self.estimate_flow(xref1, xref2, down_ratio)
        fref1 = self.feature_extractor(xref1)
        fref2 = self.feature_extractor(xref2)
        cond, flows = [], []
        for i in range(3):
            f1, f2, w1, w2, flow = self.warped_refs_at_layer(
                fref1[i], fref2[i], flow, scale1, scale2
            )
            cond.append(torch.cat([w1, w2, fref1[i], fref2[i]], dim=-1))
            flows.append((f1, f2))
        cond = tuple(cond)
        offset_temp = self.offset_temporal_conditioner(*cond)
        return cond, offset_temp, tuple(flows), fref1, fref2

    def features(self, x):
        return self.feature_extractor(x)

    def fuse_offsets(self, heads, fref1, fref2, flows):
        """OffsetDiversity fusion of the decoded offset heads -> x_comp."""
        divs = (self.offset_diversity_l1, self.offset_diversity_l2,
                self.offset_diversity_l3)
        out = []
        for i in range(3):
            o1, o2 = torch.chunk(heads[i], 2, dim=-1)
            out.append(divs[i](fref1[i], o1, flows[i][0], fref2[i], o2, flows[i][1]))
        return tuple(out)

    def residual_cond(self, x_comp):
        return self.residue_temporal_conditioner(*x_comp)

    def reconstruct(self, x1, x2, x3):
        return self.reconstructor(x1, x2, x3)

    def forward(self, xref1, xref2, xcur, s, scale1=0.5, scale2=-0.5,
                down_ratio: int = 1, mode: str = "ste",
                generator: torch.Generator | None = None):
        B, H, W, _ = xcur.shape
        cond, offset_temp, flows, fref1, fref2 = self.decoder_context(
            xref1, xref2, scale1, scale2, down_ratio
        )
        fcur = self.feature_extractor(xcur)
        inputs = tuple(torch.cat([c, f], dim=-1) for c, f in zip(cond, fcur))
        off = self.offset_compressor(inputs, cond, offset_temp, s, mode=mode,
                                     generator=generator)
        x_comp = self.fuse_offsets((off["out1"], off["out2"], off["out3"]),
                                   fref1, fref2, flows)
        res_temp = self.residual_cond(x_comp)
        res_inputs = tuple(torch.cat([f, xc], dim=-1) for f, xc in zip(fcur, x_comp))
        res = self.residual_compressor(res_inputs, x_comp, res_temp, s, mode=mode,
                                       generator=generator)
        x_hat = self.reconstruct(
            *(xc + r for xc, r in zip(x_comp, (res["out1"], res["out2"], res["out3"])))
        )
        liks = list(off["likelihoods"].values()) + list(res["likelihoods"].values())
        bits = sum(likelihood_to_bits(p) for p in liks)
        return {
            "x_hat": x_hat,
            "size": bits,
            "sizes": sum(per_sample_bits(p) for p in liks),
            "rate": bits / (B * H * W),
        }

    def prediction_flowonly(self, xref1, xref2, scale1, scale2, down_ratio: int = 1):
        """Flow-only prediction (the down-ratio search's cheap estimate): both
        references warped at full resolution by the scaled, upsampled flow,
        averaged."""
        scale1, scale2 = convert_scales(scale1, scale2)
        flow = self.estimate_flow(xref1, xref2, down_ratio)
        H, W = xref1.shape[-3], xref1.shape[-2]
        flow_21, flow_12 = torch.chunk(bilinear_resize(flow, H, W) * 2.0, 2, dim=-1)
        wref1 = warp(xref1, flow_21 * scale1)
        wref2 = warp(xref2, flow_12 * scale2)
        return 0.5 * wref1 + 0.5 * wref2

    def aux_loss(self):
        return self.offset_compressor.aux_loss() + self.residual_compressor.aux_loss()


class FlowGuidedBCoder(CondPairCoder):
    """Real-bitstream encode/decode for the v4 codec
    (:class:`~tpuvc_torch.models.bframe_coder.CondPairCoder`).

    The decoder recomputes flow, features, warps and temporal priors from
    the reconstructed references (the deform and warp kernels use no
    atomics). The temporal geometry is (scale1, scale2, down_ratio), in
    each stream's header.

    Inputs are NHWC float32 frames whose sides divide by 16.
    """

    @staticmethod
    def _header(s, scale1, scale2, down_ratio, z_shape, streams):
        return VFrameBitstream(
            s_milli=int(round(float(s) * 1000)),
            down_ratio=int(down_ratio),
            scale1_centi=int(round(float(scale1) * 100)),
            scale2_centi=int(round(float(scale2) * 100)),
            z_shape=tuple(z_shape),
            streams=list(streams),
        )

    @staticmethod
    def _geometry(bitstream):
        return (bitstream.scale1_centi / 100.0, bitstream.scale2_centi / 100.0,
                int(bitstream.down_ratio))

    def _context(self, xref1, xref2, scale1, scale2, down_ratio):
        cond, offset_temp, flows, fref1, fref2 = self.model.decoder_context(
            xref1, xref2, scale1, scale2, down_ratio
        )
        return cond, offset_temp, (fref1, fref2, flows)

    def encode_recon(self, xref1, xref2, xcur, s, scale1, scale2, down_ratio: int = 1):
        """Encode (the whole batch in one stream set) and return
        (VFrameBitstream, decoder-identical reconstruction)."""
        return self._encode_recon(xref1, xref2, xcur, s, (scale1, scale2, down_ratio))

    def encode_level_batch_async(self, xref1, xref2, xcur, s, scale1, scale2,
                                 down_ratio: int = 1):
        """:meth:`CondPairCoder._encode_level_batch_async`, one (scale1,
        scale2, down_ratio) for the level: (resolve, x_hat (B, ...))."""
        return self._encode_level_batch_async(xref1, xref2, xcur, s,
                                              (scale1, scale2, down_ratio))
