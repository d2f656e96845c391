"""Flex-Rate, the v2 B-frame codec: one model, many rates through gain units
(port of tpuvc.models.flexrate).

- GainModule: a learned per-level, per-channel latent gain, interpolated
  between adjacent levels as |g_n|^l * |g_{n+1}|^(1-l); separate forward,
  inverse and hyper instances in each codec.
- FlexFlowCompressor: a gained mean-scale hyperprior over a 19-channel
  motion context, emitting a 4-channel flow *refinement* (its last conv
  starts at zero).
- FlexResidualCompressor: the same over the 3-channel residual.
- BidirFlowRef: UNet flow prediction between the references, projected to
  t=0.5, refined by the coded flow, four warps (``compat="flexrate"``: a
  half-pixel shift over a zero ring, as the reference's grid_sample call
  samples), a 2-channel soft-mask blend and a coded residual.

tpuvc's behavioural fixes against its reference carry over: the gained
latent is coded in both the forward and the stream path, and decoded flow
refinements and residuals are not clamped. tpuvc orders its warp kernels
with ``sequenced`` against a TPU scheduling hazard; kernels on one CUDA
stream run in issue order, so the port has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpuvc_torch import resolve_device
from tpuvc_torch.coder.container import BFrameBitstream
from tpuvc_torch.entropy.emath import per_sample_bits
from tpuvc_torch.models.hyperprior import HyperpriorCoder, MeanScaleHyperprior
from tpuvc_torch.models.layers import init_weights
from tpuvc_torch.models.unet import UNet
from tpuvc_torch.ops.precision import set_deterministic
from tpuvc_torch.ops.warp import warp
from tpuvc_torch.parallel.mesh import sharded_level_decode_async, sharded_level_encode

#: tpuvc's ``flexrate._per_sample_bits``: bits per sample, summed over H, W, C.
_per_sample_bits = per_sample_bits


class GainModule(nn.Module):
    """Per-level, per-channel latent gain with fractional-level
    interpolation. ``n`` is a level index, or a (B,) tensor of one level per
    sample; ``l`` in (0, 1] weighs level n against n + 1 (clipped to the
    last level). The exponents l and 1 - l are float32, as tpuvc computes
    them."""

    def __init__(self, n_levels: int = 6, channels: int = 128):
        super().__init__()
        self.n_levels = n_levels
        self.gain_matrix = nn.Parameter(torch.ones(n_levels, channels))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.gain_matrix.fill_(1.0)

    def forward(self, x, n, l=1.0):
        g = self.gain_matrix
        l32 = np.float32(l)
        e1, e2 = float(l32), float(np.float32(1.0) - l32)
        if isinstance(n, torch.Tensor) and n.dim() > 0:
            n = n.to(device=g.device, dtype=torch.long)
            upper = torch.clamp(n + 1, 0, self.n_levels - 1)
            gain = torch.abs(g[n]) ** e1 * torch.abs(g[upper]) ** e2
            return x * gain[:, None, None, :]
        n = int(n)
        upper = max(0, min(n + 1, self.n_levels - 1))
        return x * (torch.abs(g[n]) ** e1 * torch.abs(g[upper]) ** e2)


class GainedHyperprior(MeanScaleHyperprior):
    """Mean-scale hyperprior with forward and inverse gain units on y and z."""

    def __init__(self, N: int = 128, n_levels: int = 6, out_channels: int | None = None,
                 zero_init_out: bool = False, in_channels: int | None = None):
        super().__init__(N=N, out_channels=out_channels, zero_init_out=zero_init_out,
                         in_channels=in_channels)
        self.n_levels = n_levels
        self.gain_unit = GainModule(n_levels, N)
        self.inv_gain_unit = GainModule(n_levels, N)
        self.hyper_gain_unit = GainModule(n_levels, N)
        self.hyper_inv_gain_unit = GainModule(n_levels, N)

    def gained_analysis(self, x, n, l=1.0):
        y = self.gain_unit(self.g_a(x), n, l)
        return y, self.hyper_gain_unit(self.h_a(y), n, l)

    def gained_entropy_params(self, z_hat, n, l=1.0):
        return self.entropy_params(self.hyper_inv_gain_unit(z_hat, n, l))

    def gained_synthesis(self, y_hat, n, l=1.0):
        return self.g_s(self.inv_gain_unit(y_hat, n, l))

    def forward(self, x, n, l=1.0, mode: str = "noise", generator=None):
        scaled_y, scaled_z = self.gained_analysis(x, n, l)
        z_hat, z_lik = self.entropy_bottleneck(scaled_z, mode, generator=generator)
        scales, means = self.gained_entropy_params(z_hat, n, l)
        y_hat, y_lik = self.gaussian(scaled_y, scales, means=means, mode=mode,
                                     generator=generator)
        return {"x_hat": self.gained_synthesis(y_hat, n, l),
                "likelihoods": {"y": y_lik, "z": z_lik}}


class FlexFlowCompressor(GainedHyperprior):
    """19-channel motion context in, 4-channel flow refinement out; the last
    synthesis conv starts at zero."""

    out_channels = 4

    def __init__(self, N: int = 128, n_levels: int = 6, in_channels: int = 19,
                 zero_init_out: bool = True):
        super().__init__(N=N, n_levels=n_levels, zero_init_out=zero_init_out,
                         in_channels=in_channels)


class FlexResidualCompressor(GainedHyperprior):
    """3-channel pixel residual in and out."""

    out_channels = 3


def project_flow(flow, t: float = 0.5):
    """The predicted bidirectional flow (4 channels) projected to time t
    (linear motion) -> (flow_t_0, flow_t_1)."""
    flow_0_1, flow_1_0 = flow[..., :2], flow[..., 2:4]
    flow_t_0 = -(1 - t) * t * flow_0_1 + t * t * flow_1_0
    flow_t_1 = (1 - t) * (1 - t) * flow_0_1 - t * (1 - t) * flow_1_0
    return flow_t_0, flow_t_1


def blend(mask_logits, x_b, x_a):
    """The two warped references blended by the 2-channel soft mask."""
    m = torch.sigmoid(mask_logits)
    w1 = 0.5 * m[..., 0:1]
    w2 = 0.5 * m[..., 1:2]
    return (w1 * x_b + w2 * x_a) / (w1 + w2 + 1e-8)


class BidirFlowRef(nn.Module):
    """The Flex-Rate B-frame codec: flow prediction plus a coded refinement.
    ``generator`` draws the initial weights (tpuvc's initialisers); a
    trained model loads a state dict instead (tpuvc_torch.utils.convert)."""

    def __init__(self, n_levels: int = 6, N: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_levels, self.N = n_levels, N
        self.flow_predictor = UNet(6, out_channels=4, depth=5, wf=5)
        self.mask = UNet(16, out_channels=2, depth=4, wf=5)
        self.flow_compressor = FlexFlowCompressor(N=N, n_levels=n_levels)
        self.residual_compressor = FlexResidualCompressor(N=N, n_levels=n_levels)
        if generator is not None:
            init_weights(self, generator)

    def process(self, x0, x1, t: float = 0.5):
        """Predict the bidirectional flow and project it to time t (linear
        motion); -> (flow_t_0, flow_t_1, the 16-channel motion context)."""
        x = torch.cat([x0, x1], dim=-1)
        flow_t_0, flow_t_1 = project_flow(self.flow_predictor(x), t)
        xt1 = warp(x0, flow_t_0, compat="flexrate")
        xt2 = warp(x1, flow_t_1, compat="flexrate")
        context = torch.cat([flow_t_0, flow_t_1, x, xt1, xt2], dim=-1)
        return flow_t_0, flow_t_1, context

    def compensate(self, x_before, x_after, mv_before, mv_after):
        """Warp both references and blend them with the 2-channel soft mask."""
        x_b = warp(x_before, mv_before, compat="flexrate")
        x_a = warp(x_after, mv_after, compat="flexrate")
        ctx = torch.cat([mv_before, mv_after, x_before, x_after, x_b, x_a], dim=-1)
        return blend(self.mask(ctx), x_b, x_a)

    def forward(self, x_before, x_current, x_after, n, l=1.0, mode: str = "noise",
                generator: torch.Generator | None = None):
        """Likelihood forward; ``size`` is per sample (bits summed over C, H,
        W), ``rate`` bits per pixel of one frame."""
        num_pixels = x_current.shape[1] * x_current.shape[2]
        mv_before, mv_after, context = self.process(x_before, x_after)
        flow_out = self.flow_compressor(torch.cat([context, x_current], dim=-1), n, l,
                                        mode=mode, generator=generator)
        flow_hat = flow_out["x_hat"]
        x_comp = self.compensate(x_before, x_after, mv_before + flow_hat[..., :2],
                                 mv_after + flow_hat[..., 2:4])
        res_out = self.residual_compressor(x_current - x_comp, n, l, mode=mode,
                                           generator=generator)
        liks = list(flow_out["likelihoods"].values()) + list(res_out["likelihoods"].values())
        size = sum(_per_sample_bits(p) for p in liks)
        return {
            "x_hat": x_comp + res_out["x_hat"],
            "x_comp": x_comp,
            "size": size,
            "rate": size / num_pixels,
        }

    def aux_loss(self):
        return self.flow_compressor.aux_loss() + self.residual_compressor.aux_loss()


class GainedHyperpriorCoder(HyperpriorCoder):
    """Real-bitstream path of a GainedHyperprior at a rate (n, l): every
    coding method of :class:`HyperpriorCoder` takes (n, l) after its own
    arguments. The gains enter only the device transforms; the host rANS
    and the worker pools are HyperpriorCoder's."""

    @torch.no_grad()
    def analyze_quantized(self, x, n, l=1.0):
        """Encoder-only front: gained analysis + z quantization."""
        y, z = self.module.gained_analysis(x, n, l)
        return (y, *self.quantize_z(z))

    @torch.no_grad()
    def params_idx(self, z_hat, n, l=1.0):
        scales, means = self.module.gained_entropy_params(z_hat, n, l)
        return means, self.gaussian.build_indexes(scales).to(torch.uint8)

    @torch.no_grad()
    def synthesize(self, y_hat, n, l=1.0):
        return self.module.gained_synthesis(y_hat, n, l)


class FlexRateCoder:
    """Real-bitstream encode/decode for the Flex-Rate codec at a rate (n, l).

    The decoder re-runs the flow prediction on the reconstructed references,
    decodes the refinement, compensates and adds the decoded residual; the
    encoder reconstructs through the same functions at the same batch
    shapes, with deterministic CUDA kernels (:func:`set_deterministic`; the
    warp kernel uses no atomics). Each frame's stream is a BFrameBitstream
    whose ``rate_id`` packs n * 100000 + round(l * 1000).

    ``device`` defaults to ``cuda``; the model moves there. Inputs are NHWC
    float32 frames whose sides divide by 64.
    """

    def __init__(self, model: BidirFlowRef, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_deterministic()
        self.model = model.to(self.device).eval()
        self.flow_coder = GainedHyperpriorCoder(self.model.flow_compressor)
        self.res_coder = GainedHyperpriorCoder(self.model.residual_compressor)
        self.shard = None  # see set_shard

    def set_shard(self, shard) -> None:
        """Shard level-batched coding over a mesh, as
        :meth:`tpuvc_torch.models.lhbdc.LHBDCCoder.set_shard` describes."""
        self.shard = shard

    def _to(self, *xs):
        return [x.to(self.device) for x in xs]

    @staticmethod
    def rate_id(n: int, l: float) -> int:
        return int(n) * 100000 + int(round(l * 1000))

    @staticmethod
    def parse_rate_id(rate_id: int) -> tuple[int, float]:
        return rate_id // 100000, (rate_id % 100000) / 1000.0

    def _flow_front(self, context, xc, n, l):
        """Encoder-only: gained MV analysis of [context | current] + z
        quantization; the context comes from the decoder-shared ``process``."""
        y, z = self.model.flow_compressor.gained_analysis(torch.cat([context, xc], dim=-1), n, l)
        return (y, *self.flow_coder.quantize_z(z))

    def _res_front(self, xc, x_comp, n, l):
        """Encoder-only: gained residual analysis + z quantization."""
        y, z = self.model.residual_compressor.gained_analysis(xc - x_comp, n, l)
        return (y, *self.res_coder.quantize_z(z))

    def _compensate(self, x_before, x_after, process, flow_hat):
        mv_before, mv_after, _ = process
        return self.model.compensate(x_before, x_after, mv_before + flow_hat[..., :2],
                                     mv_after + flow_hat[..., 2:4])

    @staticmethod
    def _bits(rate_id, mv_shape, res_shape, mv_strings, res_strings):
        return BFrameBitstream(
            rate_id=rate_id, mv_shape=tuple(mv_shape), res_shape=tuple(res_shape),
            mv_y=mv_strings[0], mv_z=mv_strings[1],
            res_y=res_strings[0], res_z=res_strings[1],
        )

    def encode(self, x_before, x_current, x_after, n: int, l: float = 1.0):
        return self.encode_recon(x_before, x_current, x_after, n, l)[0]

    @torch.no_grad()
    def encode_recon(self, x_before, x_current, x_after, n: int, l: float = 1.0):
        """Encode (the whole batch in one stream set) and return
        (BFrameBitstream, decoder-identical reconstruction): both codecs
        synthesise from their quantized latents, as the decoder does."""
        x_before, x_current, x_after = self._to(x_before, x_current, x_after)
        process = self.model.process(x_before, x_after)
        mv = self.flow_coder.compress_from(*self._flow_front(process[2], x_current, n, l), n, l)
        x_comp = self._predict_batch(x_before, x_after, mv["y_hat"], n, l, process=process)
        res = self.res_coder.compress_from(*self._res_front(x_current, x_comp, n, l), n, l)
        bits = self._bits(self.rate_id(n, l), mv["shape"], res["shape"],
                          mv["strings"], res["strings"])
        return bits, x_comp + self.res_coder.synthesize(res["y_hat"], n, l)

    def _predict_batch(self, x_before, x_after, flow_y_hat, n, l, process=None):
        """Batched prediction shared by encoder and decoder; ``process``: the
        encoder's own ``process`` output for the same references (the
        decoder recomputes it with the same functions and shapes)."""
        if process is None:
            process = self.model.process(x_before, x_after)
        flow_hat = self.flow_coder.synthesize(flow_y_hat, n, l)
        return self._compensate(x_before, x_after, process, flow_hat)

    @sharded_level_encode
    @torch.no_grad()
    def encode_level_batch_async(self, x_before, x_current, x_after, n: int,
                                 l: float = 1.0):
        """Batched real coding of one hierarchy level with deferred host
        phases: the device work is issued now, and ``resolve()`` returns the
        per-frame BFrameBitstreams when the workers finish. Returns
        (resolve, x_hat (B, ...)), x_hat decoder-identical."""
        x_before, x_current, x_after = self._to(x_before, x_current, x_after)
        process = self.model.process(x_before, x_after)
        mv = self.flow_coder.compress_batch_async(
            *self._flow_front(process[2], x_current, n, l), n, l
        )
        x_comp = self._predict_batch(x_before, x_after, mv["y_hat"], n, l, process=process)
        res = self.res_coder.compress_batch_async(*self._res_front(x_current, x_comp, n, l), n, l)
        x_hat = x_comp + self.res_coder.synthesize(res["y_hat"], n, l)
        rate_id, batch = self.rate_id(n, l), x_current.shape[0]
        # Keep only futures and shapes: the y_hat tensors need not outlive
        # this call.
        mv_fut, res_fut = mv["strings_future"], res["strings_future"]
        mv_shape, res_shape = mv["shape"], res["shape"]

        def resolve():
            mv_strings, res_strings = mv_fut.result(), res_fut.result()
            return [self._bits(rate_id, mv_shape, res_shape, mv_strings[b], res_strings[b])
                    for b in range(batch)]

        return resolve, x_hat

    def encode_level_batch(self, x_before, x_current, x_after, n: int, l: float = 1.0):
        """Blocking variant: ([BFrameBitstream] * B, x_hat (B, ...))."""
        resolve, x_hat = self.encode_level_batch_async(x_before, x_current, x_after, n, l)
        return resolve(), x_hat

    @sharded_level_decode_async
    def decode_level_batch_async(self, bitstreams):
        """Start one level's entropy decode now (host rANS and the gained
        entropy parameters on workers; it needs no references) and return
        ``resolve(x_before, x_after)``, which runs the reference-dependent
        device tail (flow prediction, compensation, residual synthesis)."""
        n, l = self.parse_rate_id(bitstreams[0].rate_id)
        flow_f = self.flow_coder.decompress_batch_async(
            [(b.mv_y, b.mv_z) for b in bitstreams], bitstreams[0].mv_shape, n, l
        )
        res_f = self.res_coder.decompress_batch_async(
            [(b.res_y, b.res_z) for b in bitstreams], bitstreams[0].res_shape, n, l
        )

        @torch.no_grad()
        def resolve(x_before, x_after):
            x_before, x_after = self._to(x_before, x_after)
            x_comp = self._predict_batch(x_before, x_after, flow_f.result(), n, l)
            return x_comp + self.res_coder.synthesize(res_f.result(), n, l)

        return resolve

    def decode_level_batch(self, x_before, x_after, bitstreams):
        """Blocking variant of decode_level_batch_async."""
        return self.decode_level_batch_async(bitstreams)(x_before, x_after)

    @torch.no_grad()
    def decode(self, x_before, x_after, bitstream: BFrameBitstream):
        """Inverse of encode (one stream set for the batch)."""
        x_before, x_after = self._to(x_before, x_after)
        batch = x_before.shape[0]
        n, l = self.parse_rate_id(bitstream.rate_id)
        process = self.model.process(x_before, x_after)
        flow_hat = self.flow_coder.decompress([bitstream.mv_y, bitstream.mv_z],
                                              bitstream.mv_shape, n, l, batch=batch)
        x_comp = self._compensate(x_before, x_after, process, flow_hat)
        res_hat = self.res_coder.decompress([bitstream.res_y, bitstream.res_z],
                                            bitstream.res_shape, n, l, batch=batch)
        return x_comp + res_hat
