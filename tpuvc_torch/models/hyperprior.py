"""Mean-scale hyperprior compressors, the LHBDC latent codecs (port of
tpuvc.models.hyperprior).

  - MVCompressor: 4-channel flow-difference codec; g_a = 3x(ResBlockStride +
    ResBlock) + conv/s2 to /16, h_a = five conv3x3 (/4 further), h_s =
    subpel up x4 to 2N entropy parameters, g_s mirrors g_a.
  - ResidualCompressor: the same over the 3-channel pixel residual.

``HyperpriorCoder`` runs the real bitstream path: transforms and entropy
parameters on the device, symbol <-> byte conversion by host rANS.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpuvc_torch import obs
from tpuvc_torch.entropy.bottleneck import FactorizedBottleneck, FactorizedTables
from tpuvc_torch.entropy.gaussian import GaussianConditional
from tpuvc_torch.entropy.quant import quantize
from tpuvc_torch.models.layers import (
    Conv,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    SubpelConv,
)


class MeanScaleHyperprior(nn.Module):
    """Generic mean-scale hyperprior over ``out_channels`` signal channels
    (the input has as many channels as the output unless ``in_channels``
    says otherwise)."""

    out_channels: int = 3

    def __init__(self, N: int = 128, out_channels: int | None = None,
                 zero_init_out: bool = False, in_channels: int | None = None):
        super().__init__()
        if out_channels is not None:
            self.out_channels = out_channels
        C = self.out_channels
        self.N = N
        self.entropy_bottleneck = FactorizedBottleneck(channels=N)
        self.gaussian = GaussianConditional()

        ga = []
        cin = C if in_channels is None else in_channels
        for _ in range(3):
            ga += [ResidualBlockWithStride(cin, N), ResidualBlock(N, N)]
            cin = N
        ga += [Conv(N, N, kernel=3, stride=2)]
        self.g_a_layers = nn.ModuleList(ga)

        self.h_a_convs = nn.ModuleList(
            Conv(N, N, kernel=3, stride=s) for s in (1, 1, 2, 1, 2)
        )

        self.h_s_conv0 = Conv(N, N, kernel=3)
        self.h_s_up0 = SubpelConv(N, N, r=2)
        self.h_s_conv1 = Conv(N, N * 3 // 2, kernel=3)
        self.h_s_up1 = SubpelConv(N * 3 // 2, N * 3 // 2, r=2)
        self.h_s_out = Conv(N * 3 // 2, N * 2, kernel=3)

        gs = []
        for _ in range(3):
            gs += [ResidualBlock(N, N), ResidualBlockUpsample(N, N)]
        gs += [
            ResidualBlock(N, N),
            SubpelConv(N, C, r=2, zero_init=zero_init_out),
        ]
        self.g_s_layers = nn.ModuleList(gs)

    def g_a(self, x):
        for layer in self.g_a_layers:
            x = layer(x)
        return x

    def h_a(self, y):
        x = y
        n = len(self.h_a_convs)
        for i, c in enumerate(self.h_a_convs):
            x = c(x, "leaky_relu" if i < n - 1 else None)
        return x

    def h_s(self, z_hat):
        x = self.h_s_conv0(z_hat, "leaky_relu")
        x = self.h_s_up0(x, "leaky_relu")
        x = self.h_s_conv1(x, "leaky_relu")
        x = self.h_s_up1(x, "leaky_relu")
        return self.h_s_out(x)

    def g_s(self, y_hat):
        x = y_hat
        for layer in self.g_s_layers:
            x = layer(x)
        return x

    @obs.stage
    def analysis(self, x):
        y = self.g_a(x)
        return y, self.h_a(y)

    @obs.stage
    def entropy_params(self, z_hat):
        scales, means = torch.chunk(self.h_s(z_hat), 2, dim=-1)
        return scales, means

    @obs.stage
    def synthesis(self, y_hat):
        return self.g_s(y_hat)

    def forward(self, x, mode: str = "noise", generator=None):
        """Full differentiable pass -> dict(x_hat, likelihoods)."""
        y, z = self.analysis(x)
        z_hat, z_lik = self.entropy_bottleneck(z, mode, generator=generator)
        scales, means = self.entropy_params(z_hat)
        y_hat, y_lik = self.gaussian(
            y, scales, means=means, mode=mode, generator=generator
        )
        return {"x_hat": self.synthesis(y_hat), "likelihoods": {"y": y_lik, "z": z_lik}}

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()


class MVCompressor(MeanScaleHyperprior):
    """Flow-difference codec: in 4ch (two stacked 2ch flows), out 4ch."""

    out_channels = 4


class ResidualCompressor(MeanScaleHyperprior):
    """Pixel-residual codec: in/out 3ch."""

    out_channels = 3


class HyperpriorCoder:
    """Real bitstream path of a hyperprior module: z by the factorized coder,
    y by the scale-indexed Gaussian coder conditioned on h_s(z_hat).

    Encoder and decoder run the same shared functions (``params_idx``,
    ``synthesize``) on the same shapes under the same dtype policy; with
    deterministic kernels (tpuvc_torch.ops.precision.set_deterministic) they
    compute bit-identical entropy parameters, which the rANS decode needs.

    ``*rate`` in the coding methods are the extra arguments of the module's
    rate-dependent transforms (``analyze_quantized``, ``params_idx``,
    ``synthesize``): none for a plain hyperprior, a gained one's (n, l)
    (tpuvc_torch.models.flexrate.GainedHyperpriorCoder).
    """

    def __init__(self, module: MeanScaleHyperprior):
        """``module`` sits on the device the coder runs on."""
        self.module = module
        self.device = next(module.parameters()).device
        self.z_tables = FactorizedTables.from_module(module.entropy_bottleneck)
        self.z_medians = torch.from_numpy(self.z_tables.medians).to(self.device)
        self.gaussian = GaussianConditional()
        self.y_tables = self.gaussian.build_tables()

    @torch.no_grad()
    def analyze_quantized(self, x):
        """Encoder-only front: analysis + z quantization."""
        y, z = self.module.analysis(x)
        return (y, *self.quantize_z(z))

    def quantize_z(self, z):
        """(z symbols int16, z_hat) from the analysis' z."""
        z_sym = quantize(z, "symbols16", means=self.z_medians)
        return z_sym, z_sym.float() + self.z_medians

    @torch.no_grad()
    def params_idx(self, z_hat):
        """Entropy means and rANS table indexes (uint8) from z_hat; shared by
        encoder and decoder."""
        scales, means = self.module.entropy_params(z_hat)
        return means, self.gaussian.build_indexes(scales).to(torch.uint8)

    @torch.no_grad()
    def synthesize(self, y_hat: torch.Tensor) -> torch.Tensor:
        """Decoded output from the quantized latent (decoder-identical)."""
        return self.module.synthesis(y_hat)

    def _z_index(self, shape):
        return np.broadcast_to(
            np.arange(shape[-1], dtype=np.int32), shape
        )

    def _encode_z(self, z_sym: np.ndarray) -> bytes:
        from tpuvc_torch.coder import encode_with_indexes

        t = self.z_tables
        return encode_with_indexes(
            z_sym, self._z_index(z_sym.shape), t.cdfs, t.cdf_lengths, t.offsets
        )

    def _encode_y(self, y_sym: np.ndarray, y_idx: np.ndarray) -> bytes:
        from tpuvc_torch.coder import encode_with_indexes

        t = self.y_tables
        return encode_with_indexes(y_sym, y_idx, t.cdfs, t.cdf_lengths, t.offsets)

    def _decode_z(self, z_string: bytes, shape) -> np.ndarray:
        from tpuvc_torch.coder import decode_with_indexes

        t = self.z_tables
        return decode_with_indexes(
            z_string, self._z_index(shape), t.cdfs, t.cdf_lengths, t.offsets
        ).reshape(shape)

    def _decode_y(self, y_string: bytes, y_idx: np.ndarray) -> np.ndarray:
        from tpuvc_torch.coder import decode_with_indexes

        t = self.y_tables
        return decode_with_indexes(
            y_string, y_idx, t.cdfs, t.cdf_lengths, t.offsets
        ).reshape(y_idx.shape)

    def compress(self, x: torch.Tensor, *rate) -> dict:
        return self.compress_from(*self.analyze_quantized(x, *rate), *rate)

    @torch.no_grad()
    def compress_from(self, y, z_sym_dev, z_hat, *rate) -> dict:
        """Host half of compress, from a precomputed (y, z symbols, z_hat)
        triple; the whole batch goes into one stream pair."""
        from tpuvc_torch.coder.parallel import fetch

        z_string = self._encode_z(fetch(z_sym_dev))
        means, y_idx_dev = self.params_idx(z_hat, *rate)
        y_sym_dev = quantize(y, "symbols16", means=means)
        y_string = self._encode_y(fetch(y_sym_dev), fetch(y_idx_dev))
        return {
            "strings": [y_string, z_string],
            "shape": tuple(z_sym_dev.shape[1:3]),
            "y_hat": y_sym_dev.float() + means,
        }

    def compress_batch(self, x: torch.Tensor, *rate) -> dict:
        """compress_batch_from of this coder's own analysis of ``x``."""
        return self.compress_batch_from(*self.analyze_quantized(x, *rate), *rate)

    @torch.no_grad()
    def compress_batch_async(self, y, z_sym_dev, z_hat, *rate) -> dict:
        """Batched compress with PER-SAMPLE streams: the device phase runs
        now; the host phase (symbol fetch + per-sample rANS) on a worker.

        The returned ``y_hat`` (decoder-identical quantized latent) is usable
        at once, so the caller's next device work overlaps the host coding.
        Returns {"strings_future" -> [(y_str, z_str)] * B, "shape", "y_hat"}.
        """
        from tpuvc_torch.coder.parallel import async_pool, fetch, parallel_map

        means, y_idx_dev = self.params_idx(z_hat, *rate)
        y_sym_dev = quantize(y, "symbols16", means=means)

        def host_phase():
            z_sym, y_idx, y_sym = fetch(z_sym_dev), fetch(y_idx_dev), fetch(y_sym_dev)
            return parallel_map(
                lambda b: (self._encode_y(y_sym[b], y_idx[b]),
                           self._encode_z(z_sym[b])),
                range(z_sym.shape[0]),
            )

        return {
            "strings_future": async_pool().submit(host_phase),
            "shape": tuple(z_sym_dev.shape[1:3]),
            "y_hat": y_sym_dev.float() + means,
        }

    def compress_batch_from(self, y, z_sym_dev, z_hat, *rate) -> dict:
        """Blocking variant of compress_batch_async."""
        out = self.compress_batch_async(y, z_sym_dev, z_hat, *rate)
        out["strings"] = out.pop("strings_future").result()
        return out

    @torch.no_grad()
    def decompress_batch(self, strings: list, shape, *rate) -> torch.Tensor:
        """Batched decompress of per-sample (y_str, z_str) pairs: host rANS
        per sample, device transforms once at batch B (compress_batch's
        shapes). Returns y_hat (B, ...)."""
        from tpuvc_torch.coder.parallel import fetch, parallel_map, upload

        zh, zw = shape
        zc = self.module.N
        z_sym = np.stack(
            parallel_map(
                lambda s: self._decode_z(s[1], (zh, zw, zc)).astype(np.int16),
                strings,
            )
        )
        z_hat = upload(z_sym, self.device).float() + self.z_medians
        means, y_idx_dev = self.params_idx(z_hat, *rate)
        y_idx = fetch(y_idx_dev)
        y_sym = np.stack(
            parallel_map(
                lambda bs: self._decode_y(bs[1][0], y_idx[bs[0]]).astype(np.int16),
                enumerate(strings),
            )
        )
        return upload(y_sym, self.device).float() + means

    def decompress_batch_async(self, strings: list, shape, *rate):
        """decompress_batch on a worker thread -> Future[y_hat].

        A hyperprior's entropy decode does not depend on the references (z
        comes off the stream, the entropy parameters from h_s(z_hat)), so a
        decoder submits every level's streams ahead and the workers' host
        phases hide behind the device work of earlier levels."""
        from tpuvc_torch.coder.parallel import async_pool

        return async_pool().submit(self.decompress_batch, strings, shape, *rate)

    @torch.no_grad()
    def decompress(self, strings, shape, *rate, batch: int = 1) -> torch.Tensor:
        """Inverse of compress: one stream pair for the whole batch."""
        from tpuvc_torch.coder.parallel import fetch, upload

        y_string, z_string = strings
        zh, zw = shape
        z_sym = self._decode_z(z_string, (batch, zh, zw, self.module.N))
        z_hat = upload(z_sym, self.device).float() + self.z_medians
        means, y_idx_dev = self.params_idx(z_hat, *rate)
        y_sym = self._decode_y(y_string, fetch(y_idx_dev))
        y_hat = upload(y_sym, self.device).float() + means
        return self.synthesize(y_hat, *rate)
