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

from tpuvc_torch import obs, resolve_device
from tpuvc_torch.coder.container import BFrameBitstream
from tpuvc_torch.entropy.emath import likelihood_to_bits, per_sample_bits
from tpuvc_torch.models.hyperprior import (
    HyperpriorCoder,
    MVCompressor,
    ResidualCompressor,
)
from tpuvc_torch.models.layers import init_weights
from tpuvc_torch.models.spynet import SPyNet
from tpuvc_torch.models.unet import MaskUNet
from tpuvc_torch.ops.pad import pad_to_multiple, unpad
from tpuvc_torch.ops.precision import set_deterministic
from tpuvc_torch.ops.resample import avg_pool2d, upsample_flow
from tpuvc_torch.ops.warp import warp
from tpuvc_torch.parallel.mesh import sharded_level_decode_async, sharded_level_encode


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


class LHBDCCoder:
    """Real-bitstream encode/decode for the LHBDC codec.

    The decoder re-estimates flow from the two *reconstructed* references,
    so encoder and decoder must compute bit-identical flows and entropy
    parameters: both run the same functions at the same batch shapes under
    the same dtype policy, and the constructor switches CUDA to
    deterministic kernels (:func:`set_deterministic`). The encoder rebuilds
    its prediction from the *decoded* latents, so drift is impossible.

    ``device`` defaults to ``cuda``; the model moves there. Inputs are NHWC
    float32 frames padded to x64.
    """

    def __init__(self, model: LHBDC, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_deterministic(self.device)
        self.model = model.to(self.device).eval()
        self.mv_coder = HyperpriorCoder(self.model.mv_compressor)
        self.res_coder = HyperpriorCoder(self.model.residual_compressor)
        self.shard = None  # see set_shard

    def set_shard(self, shard) -> None:
        """Shard level-batched coding over a mesh: ``shard`` from
        tpuvc_torch.parallel.mesh.level_batch_sharder, or None to code on
        this device alone.

        tpuvc applies its sharder at the inputs of every device stage, its
        sub-coders' included, and XLA keeps each array logically whole. In
        the port each rank is a process of its own, so the split is coarser:
        the level-batch entry points take this rank's rows on entry, code
        them end to end (every sub-coder stage sees the smaller batch, and
        needs no hook of its own), and gather the reconstructions (and, on
        the encoder, the per-frame streams) on exit; a level the mesh size
        does not divide is coded whole on every rank. The rule depends only
        on (batch, mesh size), so a decoder over a mesh of the same size
        (``VSequenceBitstream.mesh``) runs the encoder's batch shapes and
        reproduces its floats."""
        self.shard = shard

    def _to(self, *xs):
        return [x.to(self.device) for x in xs]

    def _motion_priors(self, x_before, x_after):
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

    @torch.no_grad()
    def encode(self, x_before, x_current, x_after, rate_id: int = 0):
        return self.encode_recon(x_before, x_current, x_after, rate_id)[0]

    @torch.no_grad()
    def encode_recon(self, x_before, x_current, x_after, rate_id: int = 0):
        """Encode one frame (the whole batch in one stream set) and return
        (BFrameBitstream, decoder-identical reconstruction)."""
        x_before, x_current, x_after = self._to(x_before, x_current, x_after)
        flow_ba, flow_ab = self._motion_priors(x_before, x_after)
        mv = self.mv_coder.compress_from(
            *self._mv_front(x_current, x_before, x_after, flow_ba, flow_ab)
        )
        # The decoder's path: MV synthesis from the decoded latent.
        flow_hat = self.mv_coder.synthesize(mv["y_hat"])
        x_pred = self._compensate(x_before, x_after, flow_ba, flow_ab, flow_hat)
        res = self.res_coder.compress_from(*self._res_front(x_current, x_pred))
        bits = BFrameBitstream(
            rate_id=rate_id,
            mv_shape=tuple(mv["shape"]),
            res_shape=tuple(res["shape"]),
            mv_y=mv["strings"][0],
            mv_z=mv["strings"][1],
            res_y=res["strings"][0],
            res_z=res["strings"][1],
        )
        return bits, x_pred + self.res_coder.synthesize(res["y_hat"])

    @torch.no_grad()
    def decode(self, x_before, x_after, bitstream: BFrameBitstream) -> torch.Tensor:
        x_before, x_after = self._to(x_before, x_after)
        batch = x_before.shape[0]
        flow_ba, flow_ab = self._motion_priors(x_before, x_after)
        flow_hat = self.mv_coder.decompress(
            [bitstream.mv_y, bitstream.mv_z], bitstream.mv_shape, batch=batch
        )
        x_pred = self._compensate(x_before, x_after, flow_ba, flow_ab, flow_hat)
        res_hat = self.res_coder.decompress(
            [bitstream.res_y, bitstream.res_z], bitstream.res_shape, batch=batch
        )
        return x_pred + res_hat

    def _predict_batch(self, x_before, x_after, mv_y_hat, flows=None):
        """Shared enc/dec batched prediction from refs + quantized MV latent.
        ``flows``: the encoder's own ``_motion_priors`` output for the same
        refs; the decoder recomputes it with the same functions and shapes,
        which gives the same values."""
        flow_ba, flow_ab = (
            flows if flows is not None else self._motion_priors(x_before, x_after)
        )
        flow_hat = self.mv_coder.synthesize(mv_y_hat)
        return self._compensate(x_before, x_after, flow_ba, flow_ab, flow_hat)

    @sharded_level_encode
    @torch.no_grad()
    def encode_level_batch_async(self, x_before, x_current, x_after,
                                 rate_id: int = 0):
        """Batched real-bitstream coding of one hierarchy level, host phases
        overlapped: the device work is issued now, and ``resolve()``
        returns the per-frame BFrameBitstreams when the workers finish.
        The caller can issue the NEXT level's device work (which needs only
        x_hat) meanwhile. Returns (resolve, x_hat (B, ...)), x_hat
        decoder-identical."""
        x_before, x_current, x_after = self._to(x_before, x_current, x_after)
        flow_ba, flow_ab = self._motion_priors(x_before, x_after)
        mv = self.mv_coder.compress_batch_async(
            *self._mv_front(x_current, x_before, x_after, flow_ba, flow_ab)
        )
        x_pred = self._predict_batch(
            x_before, x_after, mv["y_hat"], flows=(flow_ba, flow_ab)
        )
        res = self.res_coder.compress_batch_async(*self._res_front(x_current, x_pred))
        x_hat = x_pred + self.res_coder.synthesize(res["y_hat"])
        batch = x_current.shape[0]
        # Keep only futures and shapes: the y_hat tensors need not outlive
        # this call.
        mv_fut, res_fut = mv["strings_future"], res["strings_future"]
        mv_shape, res_shape = tuple(mv["shape"]), tuple(res["shape"])

        def resolve():
            mv_strings = mv_fut.result()
            res_strings = res_fut.result()
            return [
                BFrameBitstream(
                    rate_id=rate_id,
                    mv_shape=mv_shape,
                    res_shape=res_shape,
                    mv_y=mv_strings[b][0],
                    mv_z=mv_strings[b][1],
                    res_y=res_strings[b][0],
                    res_z=res_strings[b][1],
                )
                for b in range(batch)
            ]

        return resolve, x_hat

    def encode_level_batch(self, x_before, x_current, x_after, rate_id: int = 0):
        """Blocking variant: ([BFrameBitstream] * B, x_hat (B, ...))."""
        resolve, x_hat = self.encode_level_batch_async(
            x_before, x_current, x_after, rate_id
        )
        return resolve(), x_hat

    @sharded_level_decode_async
    def decode_level_batch_async(self, bitstreams):
        """Start one level's entropy decode now (host rANS + entropy
        parameters on workers; it needs no references) and return
        ``resolve(x_before, x_after)``, which runs the reference-dependent
        device tail (flow re-estimation, compensation, residual synthesis).
        A decoder submits every level's streams ahead, then walks the
        hierarchy calling resolve as reconstructions become available."""
        mv_f = self.mv_coder.decompress_batch_async(
            [(b.mv_y, b.mv_z) for b in bitstreams], bitstreams[0].mv_shape
        )
        res_f = self.res_coder.decompress_batch_async(
            [(b.res_y, b.res_z) for b in bitstreams], bitstreams[0].res_shape
        )

        @torch.no_grad()
        def resolve(x_before, x_after):
            x_before, x_after = self._to(x_before, x_after)
            x_pred = self._predict_batch(x_before, x_after, mv_f.result())
            return x_pred + self.res_coder.synthesize(res_f.result())

        return resolve

    def decode_level_batch(self, x_before, x_after, bitstreams):
        """Blocking variant of decode_level_batch_async."""
        return self.decode_level_batch_async(bitstreams)(x_before, x_after)
