"""FlowGuidedB's conditional ELIC bottlenecks (offsets and residual):
conditional analysis over per-scale inputs, gained latents (geometric
interpolation of per-level gains at rate level s), a hyper prior fused with
a temporal prior, ELIC's checkerboard and channel-group entropy model, and
an interleaved synthesis emitting one head per scale."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import entropy as E
from .checkerboard import CheckerboardConv, keep_anchor, keep_non_anchor
from .elic import _ChannelContext, _EntropyParams, code_groups
from .layers import Conv, Deconv, ResidualBottleneckBlock, named
from .ms_feature import _ConvRBB


class _SynthStage(nn.Module):
    def __init__(self, in_features: int, features: int, first_kernel: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel=first_kernel)
        named(self, "ResidualBottleneckBlock", [ResidualBottleneckBlock(features) for _ in range(3)])
        self.Deconv_0 = Deconv(features, features, kernel=5, stride=2)

    def forward(self, x):
        x = self.Conv_0(x)
        for i in range(3):
            x = getattr(self, f"ResidualBottleneckBlock_{i}")(x)
        return self.Deconv_0(x)


class _Head(nn.Module):
    def __init__(self, in_features: int, features: int, out_channels: int,
                 zero_init: bool = False):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel=3)
        named(self, "ResidualBottleneckBlock", [ResidualBottleneckBlock(features) for _ in range(3)])
        self.Conv_1 = Conv(features, out_channels, kernel=3, zero_init=zero_init)

    def forward(self, x):
        x = self.Conv_0(x)
        for i in range(3):
            x = getattr(self, f"ResidualBottleneckBlock_{i}")(x)
        return self.Conv_1(x)


class CondELIC(nn.Module):
    def __init__(self, head_channels, in_channels, cond_channels, temporal_channels: int,
                 N: int = 128, M: int = 128, levels: int = 5,
                 groups=(6, 6, 12, 24, 80), zero_head_init: bool = False):
        super().__init__()
        self.N, self.M, self.levels = N, M, levels
        self.groups = tuple(groups)
        a1, a2, a3 = in_channels
        k1, k2, k3 = cond_channels
        self.g_a1 = _ConvRBB(a1, N, kernel=5)
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
        self.prior_fusion_blocks = nn.ModuleList(ResidualBottleneckBlock(2 * M) for _ in range(3))
        self.prior_fusion_out = Conv(2 * M, 2 * M, kernel=3)
        self.entropy_parameters = nn.ModuleList(
            _EntropyParams((4 if i == 0 else 6) * M, M, 2 * g) for i, g in enumerate(self.groups))
        self.channel_context_models = nn.ModuleList(
            _ChannelContext(sum(self.groups[:i]), N, M) for i in range(1, len(self.groups)))
        self.context_prediction_models = nn.ModuleList(
            CheckerboardConv(g, M * 2, kernel=5) for g in self.groups)
        self.Gain = nn.Parameter(torch.ones(levels, M))
        self.InverseGain = nn.Parameter(torch.ones(levels, M))
        self.HyperGain = nn.Parameter(torch.ones(levels, N))
        self.InverseHyperGain = nn.Parameter(torch.ones(levels, N))
        self.entropy_bottleneck = E.FactorizedBottleneck(channels=N)

    @torch.no_grad()
    def reset_parameters(self, draws=None):
        for g in (self.Gain, self.InverseGain, self.HyperGain, self.InverseHyperGain):
            g.fill_(1.0)

    def interpolate_gain(self, s):
        """(gain, hypergain, inverse hypergain, inverse gain) at rate level
        s: geometric interpolation between the two nearest levels, the level
        and exponents as float32 host scalars."""
        s = np.clip(np.float32(s), np.float32(0.0), np.float32(self.levels - 1.0))
        upper = int(np.clip(np.ceil(s), 0, self.levels - 1))
        lower = int(np.clip(np.floor(s), 0, self.levels - 1))
        l = np.float32(upper) - s
        e_up, e_lo = float(np.float32(1.0) - l), float(l)

        def interp(g):
            return torch.abs(g[upper]) ** e_up * torch.abs(g[lower]) ** e_lo

        return (interp(self.Gain), interp(self.HyperGain), interp(self.InverseHyperGain),
                interp(self.InverseGain))

    def analysis(self, c1, c2, c3, s, x_pixel=None):
        gain, hypergain, _, _ = self.interpolate_gain(s)
        y = self.g_a1(c1)
        y = self.g_a2(torch.cat([y, c2], dim=-1))
        y = self.g_a3(torch.cat([y, c3], dim=-1)) * gain
        z = self.h_a3(F.relu(self.h_a2(F.relu(self.h_a1(y)))))
        return y, z * hypergain

    def hyper_params(self, z_hat, temporal_cond, s):
        _, _, invhypergain, _ = self.interpolate_gain(s)
        h = self.h_s3(F.relu(self.h_s2(F.relu(self.h_s1(z_hat * invhypergain)))))
        x = self.prior_fusion_in(torch.cat([h, temporal_cond], dim=-1))
        for blk in self.prior_fusion_blocks:
            x = blk(x)
        return self.prior_fusion_out(x)

    def group_params(self, i, hyper, prev_groups_hat, y_anchor_hat):
        ctx = keep_non_anchor(self.context_prediction_models[i](y_anchor_hat))
        if i == 0:
            inp = torch.cat([ctx, hyper], dim=-1)
        else:
            inp = torch.cat([ctx, self.channel_context_models[i - 1](prev_groups_hat), hyper],
                            dim=-1)
        scales, means = torch.chunk(self.entropy_parameters[i](inp), 2, dim=-1)
        return scales, means

    def synthesis(self, y_hat, cond1, cond2, cond3, s):
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

    def encode(self, inputs, conds, temporal_cond, s):
        """The coder's stream path -> (heads, bits (B,), y_hat, z_hat)."""
        y, z = self.analysis(*inputs, s)
        med = self.entropy_bottleneck.medians()
        z_hat = E.symbols(z, med) + med
        y_hat, y_bits = code_groups(self, y, self.hyper_params(z_hat, temporal_cond, s))
        bits = y_bits + E.bits(self.entropy_bottleneck.likelihood(z_hat))
        return self.synthesis(y_hat, *conds, s), bits, y_hat, z_hat

    def decode_work(self, z_hat, conds, temporal_cond, s):
        """The stream decoder's device work: the hyper prior, every group's
        two phases of entropy parameters, the synthesis."""
        y_hat, _ = code_groups(self, None, self.hyper_params(z_hat, temporal_cond, s))
        return self.synthesis(y_hat, *conds, s)

    def forward_eval(self, inputs, conds, temporal_cond, s):
        """The eval's likelihood pass (mode 'dequantize', straight-through
        context) -> (heads, bits (B,), round(y))."""
        y, z = self.analysis(*inputs, s)
        total = E.bits(self.entropy_bottleneck.likelihood(
            E.dequantize(z, self.entropy_bottleneck.medians())))
        hyper = self.hyper_params(torch.round(z), temporal_cond, s)
        groups = list(torch.split(y, self.groups, dim=-1))
        for i, curr_y in enumerate(groups):
            prev = torch.round(torch.cat(groups[:i], dim=-1)) if i > 0 else None
            scales, means = self.group_params(i, hyper, prev, keep_anchor(torch.round(curr_y)))
            total = total + E.bits(E.gaussian_likelihood(E.dequantize(curr_y, means), scales, means))
        y_hat = torch.round(y)
        return self.synthesis(y_hat, *conds, s), total, y_hat


def OffsetELIC(in_channels, cond_channels, temporal_channels, N=128, M=128, levels=5, **kw):
    """Offset bottleneck: heads emit 27*8*2 = 432 deform parameters per scale."""
    kw.setdefault("zero_head_init", True)
    return CondELIC((432, 432, 432), in_channels, cond_channels, temporal_channels,
                    N=N, M=M, levels=levels, **kw)


def ResELIC(in_channels, cond_channels, temporal_channels, N=128, M=128, levels=5,
            feature_channels=(64, 96, 128), **kw):
    """Residual bottleneck: heads emit feature residues per scale."""
    return CondELIC(tuple(feature_channels), in_channels, cond_channels, temporal_channels,
                    N=N, M=M, levels=levels, **kw)
