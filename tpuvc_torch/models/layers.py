"""Building blocks of the codec transforms (port of tpuvc.models.layers).

Every module takes and returns NHWC tensors, as tpuvc's do. A convolution
runs ``F.conv2d`` (through ``precision.conv``, which fixes its cuDNN plan
to the workspace budget) on the NCHW-permuted *view* of its input: the view has
channels-last strides, so cuDNN computes in NHWC and the permute back is free.
Submodule attribute names follow tpuvc's flax names (``Conv_0``, ``GDN_0``,
``SubpelConv_0``), so a flax parameter path maps to a state-dict key by
joining it with dots (tpuvc_torch.utils.convert).

Under the bfloat16 policy (tpuvc_torch.ops.precision) convolutions and GDN's
channel mixing take bfloat16 operands; their outputs, biases and everything
between layers stay float32.

A conv's output cast, its bias and the activation its caller applies next
(``act=``; a residual add where the module's order is conv, bias, residual)
are one pass, ``ops.epilogue.epilogue``: a hand-written kernel on a card
while autograd does not record, the same ops one by one otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from tpuvc_torch.entropy.emath import lower_bound
from tpuvc_torch.ops import precision
from tpuvc_torch.ops.epilogue import epilogue, leaky_relu  # noqa: F401 (re-exported)
from tpuvc_torch.ops.resample import pixel_shuffle

#: flax's truncated normal is cut at two standard deviations; this is the
#: standard deviation of the unit normal so truncated (flax's constant).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator | None = None):
    """flax's ``lecun_normal`` (variance 1/fan_in, truncated normal) for an
    OIHW kernel or any tensor whose dims after the first are fan-in."""
    fan_in = math.prod(w.shape[1:])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        sample = torch.empty(w.shape)
        nn.init.trunc_normal_(sample, 0.0, std, -2 * std, 2 * std, generator=generator)
        w.copy_(sample)
    return w


def conv2d_nhwc(x, weight, bias, stride: int = 1, padding: int = 0, act=None,
                slope: float = 0.01, residual=None):
    """NHWC conv with OIHW weights under the compute-dtype policy; output
    and bias add in float32, then ``+ residual`` and the activation ``act``
    (``ops.epilogue``), all in the conv's epilogue.

    While autograd records a CPU conv, the input goes in as a contiguous
    NCHW copy: oneDNN's backward of a strided conv on the channels-last view
    corrupts the heap (1x1 stride 2 over 3-8 channels aborts the process
    under torch 2.13's CPU build). Inference and CUDA take the view."""
    dt = precision.compute_dtype()
    if dt is not None:
        x = x.to(dt)
        weight = weight.to(dt)
    xin = x.permute(0, 3, 1, 2)
    if xin.device.type == "cpu" and torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad):
        xin = xin.contiguous()
    y = precision.conv(xin, weight, stride=stride, padding=padding)
    return epilogue(y, bias, act, slope, residual)


class Conv(nn.Module):
    """Conv2d with torch-style symmetric padding (pad = k//2).

    tpuvc routes large stride-1 convs through a space-to-depth layout for the
    TPU's matrix unit; that is a layout trick with no math of its own, so the
    port runs a plain conv2d with the canonical kernel.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 5,
                 stride: int = 1, zero_init: bool = False):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        if self.zero_init:
            self.weight.zero_()
        else:
            lecun_normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x, act=None, slope: float = 0.01, residual=None):
        """``act(conv(x) + bias + residual)``; ``act`` None, ``"relu"`` or
        ``"leaky_relu"`` (``slope``)."""
        return conv2d_nhwc(x, self.weight, self.bias, self.stride, self.kernel // 2,
                           act, slope, residual)


class Deconv(nn.Module):
    """ConvTranspose2d(padding=k//2, output_padding=stride-1): upsamples H, W
    by exactly ``stride``. Weight in torch's (in, out, kH, kW) layout."""

    def __init__(self, in_features: int, features: int, kernel: int = 5,
                 stride: int = 2):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(in_features, features, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        # flax's ConvTranspose kernel is (kH, kW, in, out): fan-in kH*kW*in.
        lecun_normal_(self.weight.transpose(0, 1), generator)
        self.bias.zero_()

    def forward(self, x, act=None):
        """``act(deconv(x))`` (leaky slope 0.01); the bias inside the conv,
        in its dtype."""
        dt = precision.compute_dtype()
        w, b = self.weight, self.bias
        xin = x if dt is None else x.to(dt)
        if dt is not None:
            w, b = w.to(dt), b.to(dt)
        y = precision.conv(
            xin.permute(0, 3, 1, 2), w, b, stride=self.stride,
            padding=self.kernel // 2, output_padding=self.stride - 1,
        )
        return epilogue(y, act=act, dtype=x.dtype)


def conv3x3(in_features: int, features: int, stride: int = 1) -> Conv:
    return Conv(in_features, features, kernel=3, stride=stride)


def conv1x1(in_features: int, features: int, stride: int = 1) -> Conv:
    return Conv(in_features, features, kernel=1, stride=stride)


class SubpelConv(nn.Module):
    """conv3x3 to C*r^2 channels followed by pixel shuffle (x r upsample)."""

    def __init__(self, in_features: int, features: int, r: int = 2,
                 kernel: int = 3, zero_init: bool = False):
        super().__init__()
        self.r = r
        self.Conv_0 = Conv(in_features, features * r * r, kernel=kernel,
                           zero_init=zero_init)

    def forward(self, x, act=None):
        """``act(shuffle(conv(x)))`` (leaky slope 0.01). An activation
        commutes with the shuffle: it runs in the conv's epilogue."""
        return pixel_shuffle(self.Conv_0(x, act), self.r)


class GDN(nn.Module):
    """Generalized divisive normalization (inverse when ``inverse=True``).

    y_c = x_c / sqrt(beta_c + sum_d gamma_{cd} x_d^2), with beta/gamma stored
    as lower-bounded sqrt-domain reparametrizations (compressai's GDN).
    """

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
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        ped = self.offset**2
        c = self.beta.shape[0]
        self.beta.fill_(float(np.sqrt(1.0 + ped)))
        self.gamma.copy_(torch.sqrt(self.gamma_init * torch.eye(c) + ped))

    def forward(self, x):
        ped = self.offset**2
        beta = lower_bound(self.beta, float(np.sqrt(self.beta_min + ped))) ** 2 - ped
        gamma = lower_bound(self.gamma, self.offset) ** 2 - ped
        dt = precision.compute_dtype()
        x2 = x * x
        if dt is not None:
            x2 = x2.to(dt)
            gamma = gamma.to(dt)
        norm = torch.matmul(x2, gamma.t()).float() + beta
        norm = torch.sqrt(norm)
        return x * norm if self.inverse else x / norm


class ResidualBlock(nn.Module):
    """conv3x3 -> lrelu -> conv3x3 -> lrelu, with identity (1x1 if C changes)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Conv_0 = conv3x3(in_features, features)
        self.Conv_1 = conv3x3(features, features)
        if in_features != features:
            self.Conv_2 = conv1x1(in_features, features)

    def forward(self, x):
        out = self.Conv_0(x, "leaky_relu")
        out = self.Conv_1(out, "leaky_relu")
        identity = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return out + identity


class ResidualBlockWithStride(nn.Module):
    """conv3x3/s -> lrelu -> conv3x3 -> GDN, with strided 1x1 skip."""

    def __init__(self, in_features: int, features: int, stride: int = 2):
        super().__init__()
        self.Conv_0 = conv3x3(in_features, features, stride=stride)
        self.Conv_1 = conv3x3(features, features)
        self.GDN_0 = GDN(features)
        if stride != 1 or in_features != features:
            self.Conv_2 = conv1x1(in_features, features, stride=stride)

    def forward(self, x):
        out = self.Conv_0(x, "leaky_relu")
        out = self.GDN_0(self.Conv_1(out))
        skip = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return out + skip


class ResidualBlockUpsample(nn.Module):
    """subpel x2 -> lrelu -> conv3x3 -> IGDN, with subpel skip."""

    def __init__(self, in_features: int, features: int, r: int = 2):
        super().__init__()
        self.SubpelConv_0 = SubpelConv(in_features, features, r=r)
        self.Conv_0 = conv3x3(features, features)
        self.GDN_0 = GDN(features, inverse=True)
        self.SubpelConv_1 = SubpelConv(in_features, features, r=r)

    def forward(self, x):
        out = self.SubpelConv_0(x, "leaky_relu")
        out = self.GDN_0(self.Conv_0(out))
        return out + self.SubpelConv_1(x)


class ResidualUnit(nn.Module):
    """1x1 C/2 -> relu -> 3x3 C/2 -> relu -> 1x1 C, + identity, -> relu."""

    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = conv1x1(features, features // 2)
        self.Conv_1 = conv3x3(features // 2, features // 2)
        self.Conv_2 = conv1x1(features // 2, features)

    def forward(self, x):
        out = self.Conv_0(x, "relu")
        out = self.Conv_1(out, "relu")
        return self.Conv_2(out, "relu", residual=x)


class AttentionBlock(nn.Module):
    """Cheng2020 attention: x + trunk(x) * sigmoid(gate(x)); the trunk is
    ResidualUnit_0..2, the gate ResidualUnit_3..5 and a 1x1 Conv_0."""

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
    """ELIC building block: 1x1 -> relu -> 3x3 -> relu -> 1x1, + identity,
    at full width throughout."""

    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = conv1x1(features, features)
        self.Conv_1 = conv3x3(features, features)
        self.Conv_2 = conv1x1(features, features)

    def forward(self, x):
        out = self.Conv_0(x, "relu")
        out = self.Conv_1(out, "relu")
        return self.Conv_2(out, residual=x)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of ``module`` from ``generator``, module by
    module in registration order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module
