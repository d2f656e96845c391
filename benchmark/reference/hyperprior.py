"""Mean-scale hyperprior codecs of LHBDC (the MV and residual codecs)."""

from __future__ import annotations

import torch
from torch import nn

from . import entropy as E
from .layers import (Conv, ResidualBlock, ResidualBlockUpsample, ResidualBlockWithStride,
                     SubpelConv, leaky_relu)


class MeanScaleHyperprior(nn.Module):
    out_channels: int = 3

    def __init__(self, N: int = 128):
        super().__init__()
        C = self.out_channels
        self.N = N
        self.entropy_bottleneck = E.FactorizedBottleneck(channels=N)
        ga, cin = [], C
        for _ in range(3):
            ga += [ResidualBlockWithStride(cin, N), ResidualBlock(N, N)]
            cin = N
        ga += [Conv(N, N, kernel=3, stride=2)]
        self.g_a_layers = nn.ModuleList(ga)
        self.h_a_convs = nn.ModuleList(Conv(N, N, kernel=3, stride=s) for s in (1, 1, 2, 1, 2))
        self.h_s_conv0 = Conv(N, N, kernel=3)
        self.h_s_up0 = SubpelConv(N, N, r=2)
        self.h_s_conv1 = Conv(N, N * 3 // 2, kernel=3)
        self.h_s_up1 = SubpelConv(N * 3 // 2, N * 3 // 2, r=2)
        self.h_s_out = Conv(N * 3 // 2, N * 2, kernel=3)
        gs = []
        for _ in range(3):
            gs += [ResidualBlock(N, N), ResidualBlockUpsample(N, N)]
        gs += [ResidualBlock(N, N), SubpelConv(N, C, r=2)]
        self.g_s_layers = nn.ModuleList(gs)

    def g_a(self, x):
        for layer in self.g_a_layers:
            x = layer(x)
        return x

    def h_a(self, y):
        n = len(self.h_a_convs)
        for i, c in enumerate(self.h_a_convs):
            y = c(y)
            if i < n - 1:
                y = leaky_relu(y)
        return y

    def h_s(self, z_hat):
        x = leaky_relu(self.h_s_conv0(z_hat))
        x = leaky_relu(self.h_s_up0(x))
        x = leaky_relu(self.h_s_conv1(x))
        x = leaky_relu(self.h_s_up1(x))
        return torch.chunk(self.h_s_out(x), 2, dim=-1)  # scales, means

    def g_s(self, y_hat):
        for layer in self.g_s_layers:
            y_hat = layer(y_hat)
        return y_hat

    def analysis(self, x):
        y = self.g_a(x)
        return y, self.h_a(y)

    def entropy_params(self, z_hat):
        return self.h_s(z_hat)

    def synthesis(self, y_hat):
        return self.g_s(y_hat)

    def encode(self, x):
        """Analysis and quantisation as the coder does it: z around the
        factorized prior's medians, y around the means from h_s(z_hat).
        -> (y_hat, z_hat, bits (B,))."""
        y, z = self.analysis(x)
        z_hat = E.symbols(z, self.entropy_bottleneck.medians()) + self.entropy_bottleneck.medians()
        scales, means = self.entropy_params(z_hat)
        y_hat = E.symbols(y, means) + means
        lik = (E.gaussian_likelihood(y_hat, scales, means),
               self.entropy_bottleneck.likelihood(z_hat))
        return y_hat, z_hat, sum(E.bits(p) for p in lik)

    def decode_work(self, z_hat, y_hat):
        """The decoder's device work: entropy parameters from z_hat (which
        the stream gives), then the synthesis."""
        self.entropy_params(z_hat)
        return self.synthesis(y_hat)


class MVCompressor(MeanScaleHyperprior):
    out_channels = 4


class ResidualCompressor(MeanScaleHyperprior):
    out_channels = 3
