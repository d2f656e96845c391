"""ELIC, the intra (I-frame) codec: N=192, M=320 transforms with attention,
uneven channel groups, entropy parameters per group from [checkerboard
context | channel context of the earlier groups | hyper prior].

Two semantics, as the program has them:

- :meth:`ELIC.encode` is the stream path of the sequence coder: z rounded
  around the factorized prior's medians, each group in two checkerboard
  phases around its means (anchors with zero spatial context, then the
  non-anchors with the quantized anchors as context), the channel context
  from the quantized earlier groups, g_s of the quantized latent.
- :meth:`ELIC.forward_eval` is the RD eval's likelihood pass: z and y
  rounded plainly, g_s of round(y), the bits from the likelihoods.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import entropy as E
from . import links as L
from .checkerboard import CheckerboardConv, anchor_mask, keep_anchor, keep_non_anchor
from .layers import AttentionBlock, Conv, Deconv, ResidualBottleneckBlock, leaky_relu


class _EntropyParams(nn.Module):
    def __init__(self, in_features: int, M: int, out_channels: int):
        super().__init__()
        self.Conv_0 = Conv(in_features, M * 10 // 3, kernel=1)
        self.Conv_1 = Conv(M * 10 // 3, M * 8 // 3, kernel=1)
        self.Conv_2 = Conv(M * 8 // 3, out_channels, kernel=1)

    def forward(self, x):
        x = leaky_relu(self.Conv_0(x))
        x = leaky_relu(self.Conv_1(x))
        return self.Conv_2(x)


class _ChannelContext(nn.Module):
    def __init__(self, in_features: int, N: int, M: int):
        super().__init__()
        self.Conv_0 = Conv(in_features, N, kernel=5)
        self.Conv_1 = Conv(N, N, kernel=5)
        self.Conv_2 = Conv(N, M * 2, kernel=5)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        return self.Conv_2(x)


def code_groups(m, y, hyper):
    """The stream path's two-phase checkerboard quantisation of every
    group of ``y`` (module ``m``: groups, group_params) -> (y_hat, bits
    (B,)). With ``y`` None (the decoder's device work, for counting), the
    means and scales are computed on zeros."""
    b, h, w = hyper.shape[:3]
    anchor = anchor_mask(h, w, hyper.device)
    groups_hat, total = [], 0.0
    ys = torch.split(y, m.groups, dim=-1) if y is not None else [None] * len(m.groups)
    for i, curr_y in enumerate(ys):
        prev = torch.cat(groups_hat, dim=-1) if groups_hat else None
        zeros = hyper.new_zeros((b, h, w, m.groups[i]))
        s_a, m_a = m.group_params(i, hyper, prev, zeros)
        cy = zeros if curr_y is None else curr_y
        a_hat = (E.symbols(cy, m_a) + m_a) * anchor
        s_n, m_n = m.group_params(i, hyper, prev, a_hat)
        n_hat = E.symbols(cy, m_n) + m_n
        g_hat = torch.where(anchor > 0, a_hat, n_hat)
        scales = torch.where(anchor > 0, s_a, s_n)
        means = torch.where(anchor > 0, m_a, m_n)
        total = total + E.bits(E.gaussian_likelihood(g_hat, scales, means))
        groups_hat.append(g_hat)
    return torch.cat(groups_hat, dim=-1), total


class ELIC(nn.Module):
    def __init__(self, N: int = 192, M: int = 320,
                 groups: tuple[int, ...] = (16, 16, 32, 64, 192)):
        super().__init__()
        self.N, self.M, self.groups = N, M, tuple(groups)

        def rbb3():
            return [ResidualBottleneckBlock(N) for _ in range(3)]

        self.g_a_layers = nn.ModuleList(
            [Conv(3, N, kernel=5, stride=2)] + rbb3()
            + [Conv(N, N, kernel=5, stride=2)] + rbb3()
            + [AttentionBlock(N), Conv(N, N, kernel=5, stride=2)] + rbb3()
            + [Conv(N, M, kernel=5, stride=2), AttentionBlock(M)]
        )
        self.g_s_layers = nn.ModuleList(
            [AttentionBlock(M), Deconv(M, N, kernel=5, stride=2)] + rbb3()
            + [Deconv(N, N, kernel=5, stride=2), AttentionBlock(N)] + rbb3()
            + [Deconv(N, N, kernel=5, stride=2)] + rbb3()
            + [Deconv(N, 3, kernel=5, stride=2)]
        )
        self.h_a_layers = nn.ModuleList([
            Conv(M, N, kernel=3, stride=1),
            Conv(N, N, kernel=5, stride=2),
            Conv(N, N, kernel=5, stride=2),
        ])
        self.h_s_layers = nn.ModuleList([
            Deconv(N, M, kernel=5, stride=2),
            Deconv(M, M * 3 // 2, kernel=5, stride=2),
            Conv(M * 3 // 2, M * 2, kernel=3, stride=1),
        ])
        self.entropy_parameters = nn.ModuleList(
            _EntropyParams((4 if i == 0 else 6) * M, M, 2 * g) for i, g in enumerate(self.groups))
        self.channel_context_models = nn.ModuleList(
            _ChannelContext(sum(self.groups[:i]), N, M) for i in range(1, len(self.groups)))
        self.context_prediction_models = nn.ModuleList(
            CheckerboardConv(g, M * 2, kernel=5) for g in self.groups)
        self.entropy_bottleneck = E.FactorizedBottleneck(channels=N)

    def g_a(self, x):
        for layer in self.g_a_layers:
            x = layer(x)
        return x

    def g_s(self, y_hat):
        for layer in self.g_s_layers:
            y_hat = layer(y_hat)
        return y_hat

    def h_a(self, y):
        a0, a1, a2 = self.h_a_layers
        return a2(F.relu(a1(F.relu(a0(y)))))

    def hyper_params(self, z_hat):
        s0, s1, s2 = self.h_s_layers
        return s2(F.relu(s1(F.relu(s0(z_hat)))))

    def group_params(self, i, hyper, prev_groups_hat, y_anchor_hat):
        ctx = keep_non_anchor(self.context_prediction_models[i](y_anchor_hat))
        if i == 0:
            inp = torch.cat([ctx, hyper], dim=-1)
        else:
            inp = torch.cat([ctx, self.channel_context_models[i - 1](prev_groups_hat), hyper],
                            dim=-1)
        scales, means = torch.chunk(self.entropy_parameters[i](inp), 2, dim=-1)
        return scales, means

    def encode(self, x):
        """Stream path -> (x_hat, bits (B,), {"intra": y_hat, "z": z_hat})."""
        y = self.g_a(x)
        z = self.h_a(y)
        med = self.entropy_bottleneck.medians()
        z_hat = E.symbols(z, med) + med
        y_hat, y_bits = code_groups(self, y, self.hyper_params(z_hat))
        bits = y_bits + E.bits(self.entropy_bottleneck.likelihood(z_hat))
        return self.g_s(y_hat), bits, {"intra": y_hat, "z": z_hat}

    def decode_work(self, z_hat):
        """The stream decoder's device work: h_s, every group's two phases
        of entropy parameters, g_s."""
        y_hat, _ = code_groups(self, None, self.hyper_params(z_hat))
        return self.g_s(y_hat)

    def forward_eval(self, x):
        """The eval's likelihood pass (mode 'dequantize') -> (x_hat, bits
        (B,), {"intra": round(y)})."""
        y = self.g_a(x)
        z = self.h_a(y)
        total = E.bits(self.entropy_bottleneck.likelihood(E.dequantize(z, self.entropy_bottleneck.medians())))
        hyper = self.hyper_params(torch.round(z))
        groups_hat = []
        for i, curr_y in enumerate(torch.split(y, self.groups, dim=-1)):
            curr_y_hat = torch.round(curr_y)
            prev = torch.cat(groups_hat, dim=-1) if i > 0 else None
            scales, means = self.group_params(i, hyper, prev, keep_anchor(curr_y_hat))
            total = total + E.bits(E.gaussian_likelihood(E.dequantize(curr_y, means), scales, means))
            groups_hat.append(curr_y_hat)
        y_hat = torch.round(y)
        return self.g_s(y_hat), total, {"intra": y_hat}


def assemble(model, calls: dict):
    """The reconstruction of an I-frame call: g_s of its latent."""
    args, kw, _ = calls["g_s"][0]
    return model.g_s(*args, **kw)


def follow(model, entry: dict, calls: dict, refs: dict, cfg: dict, semantics: str):
    """The steps between an I-frame call's stages (:mod:`reference.links`):
    g_a of the source frames, h_a of y, the hyper prior of z_hat, the
    groups, g_s of y_hat. -> (links, symbol pairs, the reconstruction that
    the call's last stage gives)."""
    links, flips = [], []
    x = entry["current"]
    ga_args, _, y = L.only(calls, "g_a")
    links.append(("g_a", ga_args[0], x))
    ha_args, _, z = L.only(calls, "h_a")
    links.append(("h_a", ha_args[0], y))
    med = model.entropy_bottleneck.medians()
    z_hat = E.symbols(z, med) + med if semantics == "stream" else torch.round(z)
    hp_args, _, hyper = L.only(calls, "hyper_params")
    links.append(("hyper_params", hp_args[0], z_hat))
    y_hat = L.checkerboard("group_params", model.groups, calls, refs, y, refs["g_a"][0], hyper,
                           semantics, links, flips)
    gs_args, _, out = L.only(calls, "g_s")
    links.append(("g_s", gs_args[0], y_hat))
    return links, flips, torch.clamp(out, 0.0, 1.0)
