"""Conditional gained ELIC bottlenecks, Offset_ELIC and Res_ELIC (port of
tpuvc.models.cond_elic).

- conditional analysis: g_a1..3 fold the /2, /4, /8 conditioning pyramids
  into a latent at /16 of the frame;
- four gain vectors (Gain, InverseGain, HyperGain, InverseHyperGain) with
  geometric interpolation at fractional rate levels (``interpolate_gain``);
- a hyperprior fused with a temporal condition (``prior_fusion``);
- ELIC checkerboard + channel context over uneven groups; the context
  inputs are rounded straight-through (``ctx_ste``) or quantized like the
  likelihoods;
- interleaved synthesis g_s3 -> g_o3 (head at /8), g_s2 -> g_o2 (/4),
  g_s1 -> g_o1 (/2), emitting per-scale offsets (Offset_ELIC) or feature
  residues (Res_ELIC).

``CondELICCoder`` codes real streams: two-phase checkerboard group coding
with per-sample streams for level-batched coding, host rANS on worker
threads. ``GroupCoder`` holds what it shares with the intra coder
(tpuvc_torch.models.elic.ELICCoder).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from tpuvc_torch import obs
from tpuvc_torch.entropy.bottleneck import FactorizedBottleneck, FactorizedTables
from tpuvc_torch.entropy.gaussian import GaussianConditional
from tpuvc_torch.entropy.quant import quantize, ste_round
from tpuvc_torch.models.layers import Conv, Deconv, ResidualBottleneckBlock
from tpuvc_torch.models.ms_feature import _ConvRBB, _named
from tpuvc_torch.ops.checkerboard import (
    CheckerboardConv,
    anchor_mask,
    keep_anchor,
    keep_non_anchor,
)


class _SynthStage(nn.Module):
    """conv1x1 -> 3 RBB -> deconv x2 (g_s2/g_s1 stages)."""

    def __init__(self, in_features: int, features: int, first_kernel: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel=first_kernel)
        _named(self, "ResidualBottleneckBlock",
               [ResidualBottleneckBlock(features) for _ in range(3)])
        self.Deconv_0 = Deconv(features, features, kernel=5, stride=2)

    def forward(self, x):
        x = self.Conv_0(x)
        for i in range(3):
            x = getattr(self, f"ResidualBottleneckBlock_{i}")(x)
        return self.Deconv_0(x)


class _Head(nn.Module):
    """conv3x3 -> 3 RBB -> conv3x3 to the head's channels (g_o stages).
    ``zero_init`` starts the final conv at zero (the offset flavour)."""

    def __init__(self, in_features: int, features: int, out_channels: int,
                 zero_init: bool = False):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel=3)
        _named(self, "ResidualBottleneckBlock",
               [ResidualBottleneckBlock(features) for _ in range(3)])
        self.Conv_1 = Conv(features, out_channels, kernel=3, zero_init=zero_init)

    def forward(self, x):
        x = self.Conv_0(x)
        for i in range(3):
            x = getattr(self, f"ResidualBottleneckBlock_{i}")(x)
        return self.Conv_1(x)


class _EntropyParams(nn.Module):
    def __init__(self, in_features: int, M: int, out_channels: int):
        super().__init__()
        self.Conv_0 = Conv(in_features, M * 10 // 3, kernel=1)
        self.Conv_1 = Conv(M * 10 // 3, M * 8 // 3, kernel=1)
        self.Conv_2 = Conv(M * 8 // 3, out_channels, kernel=1)

    def forward(self, x):
        x = self.Conv_0(x, "leaky_relu")
        x = self.Conv_1(x, "leaky_relu")
        return self.Conv_2(x)


class _ChannelContext(nn.Module):
    def __init__(self, in_features: int, N: int, M: int):
        super().__init__()
        self.Conv_0 = Conv(in_features, N, kernel=5)
        self.Conv_1 = Conv(N, N, kernel=5)
        self.Conv_2 = Conv(N, M * 2, kernel=5)

    def forward(self, x):
        x = self.Conv_0(x, "relu")
        x = self.Conv_1(x, "relu")
        return self.Conv_2(x)


class CondELIC(nn.Module):
    """Shared implementation; ``head_channels`` selects Offset vs Res flavour.

    head_channels: outputs of (g_o1, g_o2, g_o3), per-scale heads at /2, /4,
    /8. in_channels: widths of the analysis inputs (i1, i2, i3);
    cond_channels: widths of the decoder-side conditions (c1, c2, c3);
    temporal_channels: width of the temporal prior.
    """

    def __init__(self, head_channels: tuple[int, int, int],
                 in_channels: tuple[int, int, int],
                 cond_channels: tuple[int, int, int],
                 temporal_channels: int, N: int = 128, M: int = 128,
                 levels: int = 5, groups: tuple[int, ...] = (6, 6, 12, 24, 80),
                 pixel_stage: bool = False, ctx_ste: bool = True,
                 zero_head_init: bool = False):
        super().__init__()
        assert sum(groups) == M, (groups, M)
        self.N, self.M, self.levels = N, M, levels
        self.groups = tuple(groups)
        self.pixel_stage = pixel_stage
        self.ctx_ste = ctx_ste
        a1, a2, a3 = in_channels
        k1, k2, k3 = cond_channels
        if pixel_stage:
            self.g_a0 = _ConvRBB(3, N, kernel=5)
        self.g_a1 = _ConvRBB((N if pixel_stage else 0) + a1, N, kernel=5)
        self.g_a2 = _ConvRBB(N + a2, N, kernel=5)
        self.g_a3 = _ConvRBB(N + a3, M, kernel=5)

        self.g_s3_blocks = nn.ModuleList(ResidualBottleneckBlock(M) for _ in range(3))
        self.g_s3_up = Deconv(M, N, kernel=5, stride=2)
        zi = zero_head_init
        self.g_o3 = _Head(N + k3, N, head_channels[2], zero_init=zi)
        self.g_s2 = _SynthStage(N + k3, N)
        self.g_o2 = _Head(N + k2, N, head_channels[1], zero_init=zi)
        self.g_s1 = _SynthStage(N + k2, N)
        self.g_o1 = _Head(N + k1, N, head_channels[0], zero_init=zi)

        self.h_a1 = Conv(M, N, kernel=3)
        self.h_a2 = Conv(N, N, kernel=5, stride=2)
        self.h_a3 = Conv(N, N, kernel=5, stride=2)
        self.h_s1 = Deconv(N, M, kernel=5, stride=2)
        self.h_s2 = Deconv(M, M, kernel=5, stride=2)
        self.h_s3 = Conv(M, M, kernel=3)
        self.prior_fusion_in = Conv(M + temporal_channels, 2 * M, kernel=3)
        self.prior_fusion_blocks = nn.ModuleList(
            ResidualBottleneckBlock(2 * M) for _ in range(3)
        )
        self.prior_fusion_out = Conv(2 * M, 2 * M, kernel=3)

        self.entropy_parameters = nn.ModuleList(
            _EntropyParams((4 if i == 0 else 6) * M, M, 2 * g)
            for i, g in enumerate(self.groups)
        )
        self.channel_context_models = nn.ModuleList(
            _ChannelContext(sum(self.groups[:i]), N, M)
            for i in range(1, len(self.groups))
        )
        self.context_prediction_models = nn.ModuleList(
            CheckerboardConv(g, M * 2, kernel=5) for g in self.groups
        )

        self.Gain = nn.Parameter(torch.ones(levels, M))
        self.InverseGain = nn.Parameter(torch.ones(levels, M))
        self.HyperGain = nn.Parameter(torch.ones(levels, N))
        self.InverseHyperGain = nn.Parameter(torch.ones(levels, N))

        self.entropy_bottleneck = FactorizedBottleneck(channels=N)
        self.gaussian = GaussianConditional()

    def interpolate_gain(self, s):
        """Geometric interpolation of all four gain vectors at rate level s
        (gain, hypergain, inverse hypergain, inverse gain). The level and
        its exponents are float32 host scalars, as tpuvc computes them."""
        s = np.clip(np.float32(s), np.float32(0.0), np.float32(self.levels - 1.0))
        upper = int(np.clip(np.ceil(s), 0, self.levels - 1))
        lower = int(np.clip(np.floor(s), 0, self.levels - 1))
        l = np.float32(upper) - s
        e_up, e_lo = float(np.float32(1.0) - l), float(l)

        def interp(g):
            return torch.abs(g[upper]) ** e_up * torch.abs(g[lower]) ** e_lo

        return (
            interp(self.Gain),
            interp(self.HyperGain),
            interp(self.InverseHyperGain),
            interp(self.InverseGain),
        )

    @obs.stage
    def analysis(self, c1, c2, c3, s, x_pixel=None):
        """Conditional analysis -> gained (y, z)."""
        gain, hypergain, _, _ = self.interpolate_gain(s)
        if self.pixel_stage:
            y = self.g_a0(x_pixel)
            y = self.g_a1(torch.cat([y, c1], dim=-1))
        else:
            y = self.g_a1(c1)
        y = self.g_a2(torch.cat([y, c2], dim=-1))
        y = self.g_a3(torch.cat([y, c3], dim=-1))
        y = y * gain
        z = self.h_a3(self.h_a2(self.h_a1(y, "relu"), "relu"))
        return y, z * hypergain

    @obs.stage
    def hyper_params(self, z_hat, temporal_cond, s):
        """h_s on the inverse-gained z_hat, fused with the temporal condition."""
        _, _, invhypergain, _ = self.interpolate_gain(s)
        z_hat = z_hat * invhypergain
        h = self.h_s3(self.h_s2(self.h_s1(z_hat, "relu"), "relu"))
        x = self.prior_fusion_in(torch.cat([h, temporal_cond], dim=-1))
        for blk in self.prior_fusion_blocks:
            x = blk(x)
        return self.prior_fusion_out(x)

    @obs.stage
    def group_params(self, i: int, hyper_params, prev_groups_hat, y_anchor_hat):
        ctx = keep_non_anchor(self.context_prediction_models[i](y_anchor_hat))
        if i == 0:
            inp = torch.cat([ctx, hyper_params], dim=-1)
        else:
            channel_ctx = self.channel_context_models[i - 1](prev_groups_hat)
            inp = torch.cat([ctx, channel_ctx, hyper_params], dim=-1)
        scales, means = torch.chunk(self.entropy_parameters[i](inp), 2, dim=-1)
        return scales, means

    @obs.stage
    def synthesis(self, y_hat, cond1, cond2, cond3, s):
        """Interleaved synthesis -> per-scale head outputs (out1, out2, out3)."""
        _, _, _, invgain = self.interpolate_gain(s)
        x = y_hat * invgain
        for blk in self.g_s3_blocks:
            x = blk(x)
        inp3 = torch.cat([self.g_s3_up(x), cond3], dim=-1)
        out3 = self.g_o3(inp3)
        inp2 = torch.cat([self.g_s2(inp3), cond2], dim=-1)
        out2 = self.g_o2(inp2)
        inp1 = torch.cat([self.g_s1(inp2), cond1], dim=-1)
        return self.g_o1(inp1), out2, out3

    def forward(self, inputs, conds, temporal_cond, s, mode: str = "ste",
                generator: torch.Generator | None = None, x_pixel=None):
        """Full pass. inputs: (i1, i2, i3) analysis inputs per scale (with the
        current frame's features); conds: (c1, c2, c3) decoder-side
        conditions. mode: 'ste' (v4), 'noise' (training, needs
        ``generator``), 'dequantize' (eval)."""
        y, z = self.analysis(*inputs, s, x_pixel=x_pixel)
        lik_mode = "noise" if mode == "noise" else "dequantize"
        _, z_lik = self.entropy_bottleneck(z, lik_mode, generator=generator)
        likelihoods = {"z": z_lik}
        hyper = self.hyper_params(ste_round(z), temporal_cond, s)

        groups = list(torch.split(y, self.groups, dim=-1))

        def ctx_quant(v):
            if self.ctx_ste:
                return ste_round(v)
            return quantize(v, lik_mode, generator=generator)

        for i, curr_y in enumerate(groups):
            y_half = keep_anchor(ctx_quant(curr_y))
            prev = ctx_quant(torch.cat(groups[:i], dim=-1)) if i > 0 else None
            scales, means = self.group_params(i, hyper, prev, y_half)
            _, y_lik = self.gaussian(
                curr_y, scales, means=means, mode=lik_mode, generator=generator
            )
            likelihoods[f"y_{i}"] = y_lik

        out1, out2, out3 = self.synthesis(ste_round(y), *conds, s)
        return {"out1": out1, "out2": out2, "out3": out3,
                "likelihoods": likelihoods}

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()


def OffsetELIC(in_channels, cond_channels, temporal_channels, N: int = 128,
               M: int = 128, levels: int = 5, **kw) -> CondELIC:
    """Offset bottleneck: heads emit 27*8*2 = 432 deform parameters per scale."""
    kw.setdefault("zero_head_init", True)
    return CondELIC((432, 432, 432), in_channels, cond_channels,
                    temporal_channels, N=N, M=M, levels=levels, **kw)


def ResELIC(in_channels, cond_channels, temporal_channels, N: int = 128,
            M: int = 128, levels: int = 5,
            feature_channels: tuple[int, int, int] = (64, 96, 128),
            **kw) -> CondELIC:
    """Residual bottleneck: heads emit feature residues per scale."""
    return CondELIC(tuple(feature_channels), in_channels, cond_channels,
                    temporal_channels, N=N, M=M, levels=levels, **kw)


@functools.lru_cache(maxsize=64)
def _phase_index(h: int, w: int, device):
    """((anchor rows, cols), (non-anchor rows, cols)) index tensors on
    ``device``, uploaded once per latent size."""
    amask = anchor_mask(h, w).bool()
    return tuple(
        tuple(i.to(device) for i in torch.nonzero(m, as_tuple=True))
        for m in (amask, ~amask)
    )


class GroupCoder:
    """What the ELIC-style coders share: the z and y coding tables, the host
    rANS calls, and the two-phase checkerboard coding of one channel group.

    ``module`` provides ``N``, ``groups``, ``entropy_bottleneck`` and
    ``group_params(i, hyper, prev_groups_hat, y_anchor_hat)``, and sits on
    the device the coder runs on. Encoder and decoder run the same module
    functions at the same batch shapes under the same dtype policy, so with
    deterministic kernels (tpuvc_torch.ops.precision.set_deterministic) they
    compute the same entropy parameters, which the rANS decode needs.
    """

    def __init__(self, module: nn.Module):
        self.module = module
        self.device = next(module.parameters()).device
        self.z_tables = FactorizedTables.from_module(module.entropy_bottleneck)
        self.z_medians = torch.from_numpy(self.z_tables.medians).to(self.device)
        self.gaussian = GaussianConditional()
        self.y_tables = self.gaussian.build_tables()

    def _enc_y(self, sym, idx) -> bytes:
        from tpuvc_torch.coder import encode_with_indexes

        t = self.y_tables
        return encode_with_indexes(sym, idx, t.cdfs, t.cdf_lengths, t.offsets)

    def _enc_z(self, sym) -> bytes:
        from tpuvc_torch.coder import encode_with_indexes

        t = self.z_tables
        idx = np.broadcast_to(np.arange(self.module.N, dtype=np.int32), sym.shape)
        return encode_with_indexes(sym, idx, t.cdfs, t.cdf_lengths, t.offsets)

    def _dec_z(self, stream: bytes, shape) -> np.ndarray:
        from tpuvc_torch.coder import decode_with_indexes

        t = self.z_tables
        idx = np.broadcast_to(np.arange(self.module.N, dtype=np.int32), shape)
        return decode_with_indexes(
            stream, idx, t.cdfs, t.cdf_lengths, t.offsets
        ).reshape(shape)

    @torch.no_grad()
    def _code_group(self, i, curr_y, hyper, prev, per_sample=False, submit=False):
        """Two-phase checkerboard encoding of group i at batch B.

        per_sample=False: one stream per phase for the whole batch;
        per_sample=True: one stream per (phase, sample), so each frame of a
        level batch stays decodable on its own. With ``submit`` the
        encoder's symbol fetches and rANS run on a worker and the returned
        strings are futures. Returns (group y_hat, [anchor, non-anchor]
        strings).
        """
        from tpuvc_torch.coder.parallel import async_pool, fetch, parallel_map

        b, h, w = hyper.shape[0], hyper.shape[1], hyper.shape[2]
        gsize = self.module.groups[i]

        def enc(sym, idx):
            if not per_sample:
                return self._enc_y(sym, idx)
            return parallel_map(lambda j: self._enc_y(sym[j], idx[j]), range(b))

        def phase(prev_hat, idxs):
            pi, pj = idxs
            scales, means = self.module.group_params(i, hyper, prev, prev_hat)
            idx_dev = self.gaussian.build_indexes(scales)[:, pi, pj].to(torch.uint8)
            means = means[:, pi, pj]
            # The device chain continues from the device's own symbols
            # (int16 -> float32 is exact, so the values equal the decoder's
            # uploads); the fetch and rANS run inline or on a worker.
            sym_dev = quantize(curr_y[:, pi, pj], "symbols16", means=means)

            def host_job():
                return enc(fetch(sym_dev), fetch(idx_dev))

            out = async_pool().submit(host_job) if submit else host_job()
            return sym_dev.float() + means, out

        # Each phase's entropy parameters are computed (in stream order)
        # before its values are written into y_hat.
        anchors, non_anchors = _phase_index(h, w, self.device)
        y_hat = torch.zeros((b, h, w, gsize), dtype=torch.float32, device=self.device)
        vals_a, str_a = phase(y_hat, anchors)
        y_hat[:, anchors[0], anchors[1]] = vals_a
        vals_n, str_n = phase(y_hat, non_anchors)
        y_hat[:, non_anchors[0], non_anchors[1]] = vals_n
        return y_hat, [str_a, str_n]

    def _decode_group(self, i, hyper, prev, streams, per_sample=False):
        """Inverse of _code_group, stepwise: a generator that issues each
        phase's device work, yields at the phase's host round trip (the
        index fetch and rANS, :func:`~tpuvc_torch.coder.parallel.host_step`)
        and returns the group's y_hat. ``streams``: [anchor, non-anchor],
        each one string for the batch or, with ``per_sample``, a list of
        one a sample."""
        from tpuvc_torch.coder import decode_batch
        from tpuvc_torch.coder.parallel import host_buffer, host_step, upload

        b, h, w = hyper.shape[0], hyper.shape[1], hyper.shape[2]
        t = self.y_tables

        def dec(streams):
            def job(idx):  # one native call, a thread a stream
                sym = host_buffer(idx.shape, torch.int16, self.device)
                decode_batch(streams, idx.reshape(len(streams), -1), t.cdfs, t.cdf_lengths,
                             t.offsets, sym.numpy().reshape(len(streams), -1))
                return sym
            return job

        # Each phase's entropy parameters are computed (in stream order)
        # before its values are written into y_hat.
        phases = _phase_index(h, w, self.device)
        y_hat = torch.zeros((b, h, w, self.module.groups[i]), dtype=torch.float32,
                            device=self.device)
        for (pi, pj), strs in zip(phases, streams):
            scales, means = self.module.group_params(i, hyper, prev, y_hat)
            idx_dev = self.gaussian.build_indexes(scales)[:, pi, pj].to(torch.uint8)
            means = means[:, pi, pj]
            sym = yield from host_step(dec(strs if per_sample else [strs]), idx_dev)
            y_hat[:, pi, pj] = upload(sym, self.device, non_blocking=True).float() + means
        return y_hat

    def _decode_groups(self, hyper, streams, per_sample=False):
        """Every group in order, stepwise (as _decode_group): -> the
        batch's y_hat. ``streams``: [anchor, non-anchor] a group."""
        groups_hat = []
        for i, strs in enumerate(streams):
            g_hat = yield from self._decode_group(
                i, hyper, self._prev(groups_hat, hyper), strs, per_sample)
            groups_hat.append(g_hat)
        return torch.cat(groups_hat, dim=-1)

    def _prev(self, groups_hat, hyper):
        if groups_hat:
            return torch.cat(groups_hat, dim=-1)
        return torch.zeros(hyper.shape[:3] + (0,), dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def _code_z(self, z, z_string=None, z_shape=None, batch=1):
        """Encode z (one stream for the batch), or decode it from
        ``z_string``. Returns (z_hat, z_string, (zh, zw))."""
        from tpuvc_torch.coder.parallel import fetch, upload

        if z_string is None:
            z_sym = fetch(quantize(z, "symbols", means=self.z_medians))
            z_string = self._enc_z(z_sym)
            shape = tuple(z.shape[1:3])
        else:
            zh, zw = z_shape
            z_sym = self._dec_z(z_string, (batch, zh, zw, self.module.N))
            shape = tuple(z_shape)
        z_hat = upload(z_sym.astype(np.float32), self.device) + self.z_medians
        return z_hat, z_string, shape

    def _code_z_per_sample(self, z):
        """One z stream per sample, coded on a worker: -> (z_hat, future of
        the per-sample strings). z_hat continues from the device's own
        symbols, which equal the decoder's uploads."""
        from tpuvc_torch.coder.parallel import async_pool, fetch, parallel_map

        z_sym_dev = quantize(z, "symbols16", means=self.z_medians)

        def z_job():
            z_sym = fetch(z_sym_dev)
            return parallel_map(lambda j: self._enc_z(z_sym[j]), range(len(z_sym)))

        return z_sym_dev.float() + self.z_medians, async_pool().submit(z_job)

    def _decode_z(self, z_strings, z_shape):
        """Inverse of _code_z_per_sample, stepwise (as _decode_group): the
        batch's z_hat."""
        from tpuvc_torch.coder.parallel import host_buffer, host_step, parallel_map, upload

        shape = tuple(z_shape) + (self.module.N,)

        def job():
            z_sym = host_buffer((len(z_strings),) + shape, torch.float32, self.device)
            rows = z_sym.numpy()

            def one(j):
                rows[j] = self._dec_z(z_strings[j], shape)

            parallel_map(one, range(len(z_strings)))
            return z_sym

        z_sym = yield from host_step(job)
        return upload(z_sym, self.device, non_blocking=True) + self.z_medians


class CondELICCoder(GroupCoder):
    """Real-bitstream compress/decompress of a CondELIC bottleneck: z in the
    gained domain around the factorized prior's medians, each y group in two
    checkerboard phases around its conditional means."""

    @torch.no_grad()
    def compress(self, inputs, conds, temporal_cond, s, x_pixel=None):
        """-> {streams: [z, a0, n0, a1, n1, ...], z_shape, outs}: the whole
        batch in one stream set."""
        m = self.module
        y, z = m.analysis(*inputs, s, x_pixel=x_pixel)
        z_hat, z_string, z_shape = self._code_z(z)
        hyper = m.hyper_params(z_hat, temporal_cond, s)
        streams = [z_string]
        groups_hat = []
        for i, curr_y in enumerate(torch.split(y, m.groups, dim=-1)):
            g_hat, strs = self._code_group(i, curr_y, hyper, self._prev(groups_hat, hyper))
            groups_hat.append(g_hat)
            streams.extend(strs)
        outs = m.synthesis(torch.cat(groups_hat, dim=-1), *conds, s)
        return {"streams": streams, "z_shape": tuple(z_shape), "outs": outs}

    @torch.no_grad()
    def compress_batch_async(self, inputs, conds, temporal_cond, s, x_pixel=None):
        """Batched compress with PER-SAMPLE stream lists and deferred host
        phases: every device stage (analysis, hyper, the group x phase
        entropy parameters, synthesis) is issued without waiting for a
        symbol fetch; fetches and rANS run on worker threads.
        ``streams_resolve()`` returns the per-frame [z, a0, n0, ...] lists.

        -> {"streams_resolve", "z_shape", "outs"}.
        """
        m = self.module
        y, z = m.analysis(*inputs, s, x_pixel=x_pixel)
        b = z.shape[0]
        z_hat, z_fut = self._code_z_per_sample(z)
        hyper = m.hyper_params(z_hat, temporal_cond, s)
        group_futs, groups_hat = [], []
        for i, curr_y in enumerate(torch.split(y, m.groups, dim=-1)):
            g_hat, futs = self._code_group(
                i, curr_y, hyper, self._prev(groups_hat, hyper),
                per_sample=True, submit=True,
            )
            groups_hat.append(g_hat)
            group_futs.append(futs)
        outs = m.synthesis(torch.cat(groups_hat, dim=-1), *conds, s)

        def streams_resolve():
            per_frame = [[zs] for zs in z_fut.result()]
            for a_fut, n_fut in group_futs:
                a_strs, n_strs = a_fut.result(), n_fut.result()
                for j in range(b):
                    per_frame[j].extend([a_strs[j], n_strs[j]])
            return per_frame

        return {"streams_resolve": streams_resolve,
                "z_shape": tuple(z.shape[1:3]), "outs": outs}

    def compress_batch(self, inputs, conds, temporal_cond, s, x_pixel=None):
        """Blocking variant of compress_batch_async:
        -> {"streams": [per-frame list] * B, "z_shape", "outs"}."""
        out = self.compress_batch_async(inputs, conds, temporal_cond, s, x_pixel)
        out["streams"] = out.pop("streams_resolve")()
        return out

    @torch.no_grad()
    def decompress_batch_steps(self, per_frame_streams, z_shape, conds, temporal_cond, s):
        """decompress_batch stepwise: a generator that yields at each host
        round trip of the entropy decode (z, then each group's two phases)
        and returns the batched synthesis
        (:func:`~tpuvc_torch.coder.parallel.run_steps` drives it)."""
        m = self.module
        z_hat = yield from self._decode_z([f[0] for f in per_frame_streams], z_shape)
        hyper = m.hyper_params(z_hat, temporal_cond, s)
        streams = [[[f[1 + 2 * i] for f in per_frame_streams],
                    [f[2 + 2 * i] for f in per_frame_streams]] for i in range(len(m.groups))]
        y_hat = yield from self._decode_groups(hyper, streams, per_sample=True)
        return m.synthesis(y_hat, *conds, s)

    def decompress_batch(self, per_frame_streams, z_shape, conds, temporal_cond, s):
        """Inverse of compress_batch: per-frame stream lists in, batched
        synthesis out (the encoder's batch shapes)."""
        from tpuvc_torch.coder.parallel import run_steps

        return run_steps(self.decompress_batch_steps(
            per_frame_streams, z_shape, conds, temporal_cond, s))[0]

    @torch.no_grad()
    def decompress(self, streams, z_shape, conds, temporal_cond, s, batch=1):
        """Inverse of compress: one stream set for the whole batch."""
        from tpuvc_torch.coder.parallel import run_steps

        m = self.module
        z_hat, _, _ = self._code_z(None, z_string=streams[0], z_shape=z_shape, batch=batch)
        hyper = m.hyper_params(z_hat, temporal_cond, s)
        y_hat = run_steps(self._decode_groups(
            hyper, [streams[1 + 2 * i : 3 + 2 * i] for i in range(len(m.groups))]))[0]
        return m.synthesis(y_hat, *conds, s)
