"""Building blocks of the codec transforms, NHWC, in plain float32.

Frozen copy of the program's layer mathematics (the LHBDC, ELIC and
FlowGuidedB transforms): the same modules, the same attribute names (so a
state dict fits both), plain ``F.conv2d`` / ``F.conv_transpose2d`` /
``torch.matmul`` in float32. ``reset_parameters(draws)`` gives each leaf
its initial value through a :class:`benchmark.weights.Draws`, which makes
the random ones in a few large draws on the device; with ``draws=None``
only the constant leaves are set.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .entropy import lower_bound
from .numerics import operand
from .resample import pixel_shuffle

#: flax's truncated normal is cut at two standard deviations; this is the
#: standard deviation of the unit normal so truncated.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, draws, scale: float = 1.0) -> None:
    """Variance 1/fan_in (fan-in: every dim after the first), truncated at
    two standard deviations, times ``scale``."""
    if draws is not None:
        fan_in = math.prod(w.shape[1:])
        draws.trunc_normal(w, scale * math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def conv2d_nhwc(x, weight, bias, stride: int = 1, padding: int = 0):
    y = F.conv2d(operand(x).permute(0, 3, 1, 2), operand(weight), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1) + bias


class Conv(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 5,
                 stride: int = 1, zero_init: bool = False):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def reset_parameters(self, draws=None, head_scale: float | None = None):
        if self.zero_init and head_scale is None:
            self.weight.zero_()
        else:
            lecun_normal_(self.weight, draws, 1.0 if head_scale is None else head_scale)
        self.bias.zero_()

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, self.stride, self.kernel // 2)


class Deconv(nn.Module):
    """ConvTranspose2d(padding=k//2, output_padding=stride-1), weight in
    (in, out, kH, kW)."""

    def __init__(self, in_features: int, features: int, kernel: int = 5,
                 stride: int = 2):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(in_features, features, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def reset_parameters(self, draws=None):
        lecun_normal_(self.weight.transpose(0, 1), draws)
        self.bias.zero_()

    def forward(self, x):
        y = F.conv_transpose2d(
            operand(x).permute(0, 3, 1, 2), operand(self.weight), operand(self.bias),
            stride=self.stride, padding=self.kernel // 2, output_padding=self.stride - 1,
        )
        return y.permute(0, 2, 3, 1)


def conv3x3(in_features: int, features: int, stride: int = 1) -> Conv:
    return Conv(in_features, features, kernel=3, stride=stride)


def conv1x1(in_features: int, features: int, stride: int = 1) -> Conv:
    return Conv(in_features, features, kernel=1, stride=stride)


class SubpelConv(nn.Module):
    def __init__(self, in_features: int, features: int, r: int = 2,
                 kernel: int = 3, zero_init: bool = False):
        super().__init__()
        self.r = r
        self.Conv_0 = Conv(in_features, features * r * r, kernel=kernel, zero_init=zero_init)

    def forward(self, x):
        return pixel_shuffle(self.Conv_0(x), self.r)


class GDN(nn.Module):
    """y_c = x_c / sqrt(beta_c + sum_d gamma_cd x_d^2) (times, if inverse)."""

    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1,
                 offset: float = 2.0**-18):
        super().__init__()
        self.inverse = inverse
        self.beta_min = beta_min
        self.gamma_init = gamma_init
        self.offset = offset
        self.beta = nn.Parameter(torch.empty(channels))
        self.gamma = nn.Parameter(torch.empty(channels, channels))

    @torch.no_grad()
    def reset_parameters(self, draws=None):
        ped = self.offset**2
        c = self.beta.shape[0]
        self.beta.fill_(float(np.sqrt(1.0 + ped)))
        eye = torch.eye(c, device=self.gamma.device)
        self.gamma.copy_(torch.sqrt(self.gamma_init * eye + ped))

    def forward(self, x):
        ped = self.offset**2
        beta = lower_bound(self.beta, float(np.sqrt(self.beta_min + ped))) ** 2 - ped
        gamma = lower_bound(self.gamma, self.offset) ** 2 - ped
        norm = torch.sqrt(torch.matmul(operand(x * x), operand(gamma).t()) + beta)
        return x * norm if self.inverse else x / norm


def leaky_relu(x, slope: float = 0.01):
    return torch.where(x >= 0, x, slope * x)


class ResidualBlock(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Conv_0 = conv3x3(in_features, features)
        self.Conv_1 = conv3x3(features, features)
        if in_features != features:
            self.Conv_2 = conv1x1(in_features, features)

    def forward(self, x):
        out = leaky_relu(self.Conv_0(x))
        out = leaky_relu(self.Conv_1(out))
        identity = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return out + identity


class ResidualBlockWithStride(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 2):
        super().__init__()
        self.Conv_0 = conv3x3(in_features, features, stride=stride)
        self.Conv_1 = conv3x3(features, features)
        self.GDN_0 = GDN(features)
        if stride != 1 or in_features != features:
            self.Conv_2 = conv1x1(in_features, features, stride=stride)

    def forward(self, x):
        out = leaky_relu(self.Conv_0(x))
        out = self.GDN_0(self.Conv_1(out))
        skip = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return out + skip


class ResidualBlockUpsample(nn.Module):
    def __init__(self, in_features: int, features: int, r: int = 2):
        super().__init__()
        self.SubpelConv_0 = SubpelConv(in_features, features, r=r)
        self.Conv_0 = conv3x3(features, features)
        self.GDN_0 = GDN(features, inverse=True)
        self.SubpelConv_1 = SubpelConv(in_features, features, r=r)

    def forward(self, x):
        out = leaky_relu(self.SubpelConv_0(x))
        out = self.GDN_0(self.Conv_0(out))
        return out + self.SubpelConv_1(x)


class ResidualUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = conv1x1(features, features // 2)
        self.Conv_1 = conv3x3(features // 2, features // 2)
        self.Conv_2 = conv1x1(features // 2, features)

    def forward(self, x):
        out = F.relu(self.Conv_0(x))
        out = F.relu(self.Conv_1(out))
        return F.relu(self.Conv_2(out) + x)


class AttentionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        for i in range(6):
            setattr(self, f"ResidualUnit_{i}", ResidualUnit(features))
        self.Conv_0 = conv1x1(features, features)

    def forward(self, x):
        a = b = x
        for i in range(3):
            a = getattr(self, f"ResidualUnit_{i}")(a)
            b = getattr(self, f"ResidualUnit_{i + 3}")(b)
        return x + a * torch.sigmoid(self.Conv_0(b))


class ResidualBottleneckBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = conv1x1(features, features)
        self.Conv_1 = conv3x3(features, features)
        self.Conv_2 = conv1x1(features, features)

    def forward(self, x):
        out = F.relu(self.Conv_0(x))
        out = F.relu(self.Conv_1(out))
        return self.Conv_2(out) + x


def named(module: nn.Module, prefix: str, items) -> None:
    for i, m in enumerate(items):
        setattr(module, f"{prefix}_{i}", m)
