"""LHBDC hierarchical bi-directional B-frame codec (port of
tpuvc.models.lhbdc).

  1. SPyNet flows between the two references (halved: the linear-motion
     priors of the current frame's flows) and from the current frame to each
     reference, all pooled to /4 resolution.
  2. The differences (flow_cur->ref minus prior) are coded by a mean-scale
     hyperprior MV codec (4ch).
  3. Both references are backward-warped by the reconstructed flows, blended
     by a sigmoid occlusion mask (MaskUNet), and the pixel residual is coded
     by a second hyperprior codec.

Inputs are NHWC, padded to x64. Flows at /4 resolution are reflect-padded to
x64 before the MV codec and cropped afterwards. rate = (bits_flow +
bits_residual) / (2 * pixels); bits = total bits.
"""

from __future__ import annotations

import torch
from torch import nn

from tpuvc_torch import obs
from tpuvc_torch.entropy.emath import likelihood_to_bits, per_sample_bits
from tpuvc_torch.models.bframe_coder import HyperpriorPairCoder
from tpuvc_torch.models.hyperprior import (
    HyperpriorCoder,
    MVCompressor,
    ResidualCompressor,
)
from tpuvc_torch.models.layers import init_weights
from tpuvc_torch.models.spynet import SPyNet
from tpuvc_torch.models.unet import MaskUNet
from tpuvc_torch.ops.pad import pad_to_multiple, unpad
from tpuvc_torch.ops.resample import avg_pool2d, upsample_flow
from tpuvc_torch.ops.warp import warp


class LHBDC(nn.Module):
    """``generator`` draws the initial weights (tpuvc's initialisers); a
    trained model loads a state dict instead (tpuvc_torch.utils.convert)."""

    def __init__(self, N: int = 128, generator: torch.Generator | None = None):
        super().__init__()
        self.N = N
        self.flownet = SPyNet()
        self.mv_compressor = MVCompressor(N=N)
        self.residual_compressor = ResidualCompressor(N=N)
        self.masknet = MaskUNet()
        if generator is not None:
            init_weights(self, generator)
        obs.name_stages(self)

    def _batched_flows(self, firsts, seconds):
        """Several flow estimations as ONE batched SPyNet pass."""
        b = firsts[0].shape[0]
        flow = self.flownet(torch.cat(firsts, dim=0), torch.cat(seconds, dim=0))
        return [flow[i * b : (i + 1) * b] for i in range(len(firsts))]

    def motion_priors(self, x_before, x_after):
        """Half the ref<->ref flows at /4 res, padded to x64."""
        f_ba, f_ab = self._batched_flows([x_before, x_after], [x_after, x_before])
        flow_ba = avg_pool2d(f_ba / 2.0, 4)
        flow_ab = avg_pool2d(f_ab / 2.0, 4)
        size = (flow_ba.shape[-3], flow_ba.shape[-2])
        flow_ba, _ = pad_to_multiple(flow_ba, 64)
        flow_ab, _ = pad_to_multiple(flow_ab, 64)
        return flow_ba, flow_ab, size

    def current_flows(self, x_current, x_before, x_after):
        """Current->ref flows at /4 res, padded to x64."""
        f_cb, f_ca = self._batched_flows([x_current, x_current], [x_before, x_after])
        flow_cb, _ = pad_to_multiple(avg_pool2d(f_cb, 4), 64)
        flow_ca, _ = pad_to_multiple(avg_pool2d(f_ca, 4), 64)
        return flow_cb, flow_ca

    def all_flows(self, x_before, x_current, x_after):
        """All 4 flows in one batched SPyNet pass (forward-path route)."""
        fs = self._batched_flows(
            [x_before, x_after, x_current, x_current],
            [x_after, x_before, x_before, x_after],
        )
        size = None
        flows = []
        for f, halve in zip(fs, (True, True, False, False)):
            g = avg_pool2d(f / 2.0 if halve else f, 4)
            if size is None:
                size = (g.shape[-3], g.shape[-2])
            g, _ = pad_to_multiple(g, 64)
            flows.append(g)
        return (*flows, size)

    @obs.stage
    def motion_compensate(self, x_before, x_after, flow_cb_hat, flow_ca_hat, size):
        """Crop + x4 upsample decoded flows, warp both refs, mask-blend."""
        flow_cb_hat = upsample_flow(unpad(flow_cb_hat, size), 4)
        flow_ca_hat = upsample_flow(unpad(flow_ca_hat, size), 4)
        fw = warp(x_before, flow_cb_hat, compat="lhbdc")
        bw = warp(x_after, flow_ca_hat, compat="lhbdc")
        mask = self.masknet(torch.cat([fw, bw], dim=-1))
        return mask * fw + (1.0 - mask) * bw

    def forward(self, x_before, x_current, x_after, mode: str = "noise",
                generator: torch.Generator | None = None):
        B, H, W, _ = x_current.shape
        num_pixels = B * H * W
        flow_ba, flow_ab, flow_cb, flow_ca, size = self.all_flows(
            x_before, x_current, x_after
        )
        diff_flow = torch.cat([flow_cb - flow_ab, flow_ca - flow_ba], dim=-1)
        flow_out = self.mv_compressor(diff_flow, mode=mode, generator=generator)
        flow_cb_hat, flow_ca_hat = torch.chunk(flow_out["x_hat"], 2, dim=-1)
        flow_cb_hat = flow_cb_hat + flow_ab
        flow_ca_hat = flow_ca_hat + flow_ba

        x_pred = self.motion_compensate(
            x_before, x_after, flow_cb_hat, flow_ca_hat, size
        )
        residual = x_current - x_pred
        res_out = self.residual_compressor(residual, mode=mode, generator=generator)
        x_hat = x_pred + res_out["x_hat"]

        liks_flow = list(flow_out["likelihoods"].values())
        liks_res = list(res_out["likelihoods"].values())
        bits_flow = sum(likelihood_to_bits(p) for p in liks_flow)
        bits_res = sum(likelihood_to_bits(p) for p in liks_res)
        # Per-sample bits: level-batched GOP evaluation codes independent
        # frames in one forward and accounts each one's size.
        sizes = sum(per_sample_bits(p) for p in liks_flow + liks_res)
        return {
            "x_hat": x_hat,
            "x_pred": x_pred,
            "rate": (bits_flow + bits_res) / (2.0 * num_pixels),
            "bits": bits_flow + bits_res,
            "bits_flow": bits_flow,
            "bits_residual": bits_res,
            "sizes": sizes,
        }

    def aux_loss(self):
        return self.mv_compressor.aux_loss() + self.residual_compressor.aux_loss()


class LHBDCCoder(HyperpriorPairCoder):
    """Real-bitstream encode/decode for the LHBDC codec
    (:class:`~tpuvc_torch.models.bframe_coder.HyperpriorPairCoder`).

    The decoder re-estimates flow from the two *reconstructed* references,
    so encoder and decoder must compute bit-identical flows and entropy
    parameters. The encoder rebuilds its prediction from the *decoded*
    latents, so drift is impossible. ``rate_id`` names the weights' lambda:
    each stream records it, and no coding step reads it.

    Inputs are NHWC float32 frames padded to x64.
    """

    def __init__(self, model: LHBDC, device=None):
        super().__init__(model, device)
        self.mv_coder = HyperpriorCoder(self.model.mv_compressor)
        self.res_coder = HyperpriorCoder(self.model.residual_compressor)

    @staticmethod
    def _rate_of(rate_id):
        return ()

    def _context(self, x_before, x_after):
        return self.model.motion_priors(x_before, x_after)[:2]

    def _mv_front(self, x_current, x_before, x_after, flow_ba, flow_ab):
        """Encoder-only: current flows + MV analysis + z quantization."""
        flow_cb, flow_ca = self.model.current_flows(x_current, x_before, x_after)
        diff = torch.cat([flow_cb - flow_ab, flow_ca - flow_ba], dim=-1)
        y, z = self.model.mv_compressor.analysis(diff)
        return (y, *self.mv_coder.quantize_z(z))

    def _res_front(self, x_current, x_pred):
        """Encoder-only: residual analysis + z quantization."""
        y, z = self.model.residual_compressor.analysis(x_current - x_pred)
        return (y, *self.res_coder.quantize_z(z))

    def _compensate(self, x_before, x_after, flow_ba, flow_ab, flow_hat):
        size = (x_before.shape[1] // 4, x_before.shape[2] // 4)
        flow_cb_hat, flow_ca_hat = torch.chunk(flow_hat, 2, dim=-1)
        return self.model.motion_compensate(
            x_before, x_after, flow_cb_hat + flow_ab, flow_ca_hat + flow_ba, size
        )

    def encode_recon(self, x_before, x_current, x_after, rate_id: int = 0):
        """Encode one frame (the whole batch in one stream set) and return
        (BFrameBitstream, decoder-identical reconstruction)."""
        return self._encode_recon(x_before, x_current, x_after, (), rate_id)

    def encode_level_batch_async(self, x_before, x_current, x_after, rate_id: int = 0):
        """:meth:`HyperpriorPairCoder._encode_level_batch_async`: (resolve,
        x_hat (B, ...))."""
        return self._encode_level_batch_async(x_before, x_current, x_after, (), rate_id)
