"""DeformB, the v3 B-frame codec (port of tpuvc.models.deform_b):
feature-space deformable alignment without explicit flow.

1. 3-scale feature pyramids (32/64/96) of both references and the current
   frame.
2. Offset_ELIC codes deformable offsets and masks per scale, conditioned on
   both references' features only (no flow, no warping).
3. Per scale and per reference, an 8-group modulated deformable conv
   (tpuvc_torch.ops.deform) aligns the reference features; the two aligned
   maps are concatenated (compensated channels = 2x feature channels).
4. Res_ELIC, with an extra pixel-level analysis stage over the raw current
   frame, codes the feature residues; the deconv reconstructor decodes RGB.

tpuvc orders its deform calls with ``sequenced`` and optimisation barriers
against a TPU scheduling hazard; kernels on one CUDA stream run in issue
order, so the port has no counterpart.
"""

from __future__ import annotations

import torch
from torch import nn

from tpuvc_torch import obs
from tpuvc_torch.coder.container import VFrameBitstream
from tpuvc_torch.entropy.emath import likelihood_to_bits, per_sample_bits
from tpuvc_torch.models.bframe_coder import CondPairCoder
from tpuvc_torch.models.cond_elic import CondELIC
from tpuvc_torch.models.layers import init_weights
from tpuvc_torch.models.ms_feature import MSFeature, ReconstructorDeconv, TemporalEnc
from tpuvc_torch.ops.deform import DeformConv

#: Each reference's head: 144 offset channels (8 groups x 9 taps x (dy, dx))
#: then 72 mask logits.
N_OFFSETS = 144


def _head_to_deform(head):
    """One reference's 216 head channels -> (offsets, masks): the first 144
    go to the deformable conv verbatim, read pairwise as (dy, dx) per
    (group, tap) (torchvision's layout, which tpuvc_torch.ops.deform
    shares); the last 72 are sigmoid masks."""
    return head[..., :N_OFFSETS], torch.sigmoid(head[..., N_OFFSETS:])


class DeformB(nn.Module):
    """``generator`` draws the initial weights (tpuvc's initialisers); a
    trained model loads a state dict instead (tpuvc_torch.utils.convert)."""

    def __init__(self, feature_channels: tuple[int, int, int] = (32, 64, 96),
                 N: int = 128, M: int = 128, levels: int = 5,
                 groups: tuple[int, ...] = (6, 6, 12, 24, 80),
                 generator: torch.Generator | None = None):
        super().__init__()
        fc = tuple(feature_channels)
        self.feature_channels, self.N, self.M = fc, N, M
        self.levels, self.groups = levels, tuple(groups)
        comp = tuple(2 * c for c in fc)  # both references side by side
        inputs = tuple(3 * c for c in fc)  # [conditions | current frame]
        self.feature_extractor = MSFeature(channels=fc)
        self.offset_temp_encoder = TemporalEnc(comp, N=N, M=M)
        self.offset_compressor = CondELIC(
            (432, 432, 432), inputs, comp, M, N=N, M=M, levels=levels,
            groups=self.groups, ctx_ste=False, zero_head_init=True,
        )
        # Two deform convs per scale (one per reference), 8 groups each.
        for level, c in zip((3, 2, 1), (fc[2], fc[1], fc[0])):
            for ref in (1, 2):
                setattr(self, f"deconv_l{level}_{ref}", DeformConv(c, c, groups=8))
        self.residual_temp_encoder = TemporalEnc(comp, N=N, M=M)
        # Residues live in the concatenated (2x) compensated space.
        self.residual_compressor = CondELIC(
            comp, inputs, comp, M, N=N, M=M, levels=levels, groups=self.groups,
            pixel_stage=True, ctx_ste=False,
        )
        self.reconstructor = ReconstructorDeconv(channels=comp)
        if generator is not None:
            init_weights(self, generator)
        obs.name_stages(self)

    def _deform_pair(self, head, f1, f2, level: int):
        """Align both references' features at one scale (level 1, 2, 3) with
        the decoded head's two halves; -> the aligned maps side by side."""
        o1, o2 = torch.chunk(head, 2, dim=-1)
        d1, d2 = (getattr(self, f"deconv_l{level}_{ref}") for ref in (1, 2))
        return torch.cat([d1(f1, *_head_to_deform(o1)), d2(f2, *_head_to_deform(o2))], dim=-1)

    @obs.stage
    def decoder_context(self, xref1, xref2):
        """What the decoder computes from the references: the conditioning
        pyramid (both references' features side by side), the offset
        prior's temporal condition, and each reference's features."""
        fref1 = self.feature_extractor(xref1)
        fref2 = self.feature_extractor(xref2)
        cond = tuple(torch.cat([r1, r2], dim=-1) for r1, r2 in zip(fref1, fref2))
        return cond, self.offset_temp_encoder(*cond), fref1, fref2

    def features(self, x):
        return self.feature_extractor(x)

    @obs.stage
    def fuse_offsets(self, heads, fref1, fref2):
        """The decoded offset heads (out1, out2, out3) -> x_comp per scale."""
        return tuple(self._deform_pair(heads[i], fref1[i], fref2[i], i + 1) for i in range(3))

    @obs.stage
    def residual_cond(self, x_comp):
        return self.residual_temp_encoder(*x_comp)

    @obs.stage
    def reconstruct(self, x1, x2, x3):
        return self.reconstructor(x1, x2, x3)

    def forward(self, xref1, xref2, xcur, s, mode: str = "noise",
                generator: torch.Generator | None = None):
        """Likelihood forward. mode: 'noise' (training, needs ``generator``)
        or 'dequantize' (eval); offsets and residues are quantized like the
        likelihoods (``ctx_ste=False``)."""
        B, H, W, _ = xcur.shape
        cond, offset_temp, fref1, fref2 = self.decoder_context(xref1, xref2)
        fcur = self.feature_extractor(xcur)
        inputs = tuple(torch.cat([c, f], dim=-1) for c, f in zip(cond, fcur))
        off = self.offset_compressor(inputs, cond, offset_temp, s, mode=mode,
                                     generator=generator)
        x_comp = self.fuse_offsets((off["out1"], off["out2"], off["out3"]), fref1, fref2)
        res_inputs = tuple(torch.cat([f, xc], dim=-1) for f, xc in zip(fcur, x_comp))
        res = self.residual_compressor(res_inputs, x_comp, self.residual_cond(x_comp), s,
                                       mode=mode, generator=generator, x_pixel=xcur)
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

    def aux_loss(self):
        return self.offset_compressor.aux_loss() + self.residual_compressor.aux_loss()


class DeformBCoder(CondPairCoder):
    """Real-bitstream encode/decode for the v3 codec
    (:class:`~tpuvc_torch.models.bframe_coder.CondPairCoder`).

    The decoder recomputes the reference features and temporal priors from
    the reconstructed references (the deform kernel uses no atomics). v3
    has no temporal geometry: each header has down ratio 1 and both
    temporal scales 0.

    Inputs are NHWC float32 frames whose sides divide by 16.
    """

    @staticmethod
    def _header(s, z_shape, streams):
        return VFrameBitstream(
            s_milli=int(round(float(s) * 1000)), down_ratio=1, scale1_centi=0,
            scale2_centi=0, z_shape=tuple(z_shape), streams=list(streams),
        )

    def encode_recon(self, xref1, xref2, xcur, s):
        """Encode (the whole batch in one stream set) and return
        (VFrameBitstream, decoder-identical reconstruction)."""
        return self._encode_recon(xref1, xref2, xcur, s, ())

    def encode_level_batch_async(self, xref1, xref2, xcur, s):
        """:meth:`CondPairCoder._encode_level_batch_async`: (resolve, x_hat
        (B, ...))."""
        return self._encode_level_batch_async(xref1, xref2, xcur, s, ())
