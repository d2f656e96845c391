"""FlowGuidedB's feature pyramids, flow UNet, temporal-prior encoder and
reconstructor."""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv, ResidualBottleneckBlock, SubpelConv, named


class _ConvRBB(nn.Module):
    """conv (k, s) then ``blocks`` residual bottleneck blocks."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 2, blocks: int = 3):
        super().__init__()
        self.blocks = blocks
        self.Conv_0 = Conv(in_features, features, kernel=kernel, stride=stride)
        named(self, "ResidualBottleneckBlock", [ResidualBottleneckBlock(features) for _ in range(blocks)])

    def forward(self, x):
        x = self.Conv_0(x)
        for i in range(self.blocks):
            x = getattr(self, f"ResidualBottleneckBlock_{i}")(x)
        return x


class MSFeature(nn.Module):
    """/2, /4, /8 feature pyramid."""

    def __init__(self, channels=(64, 96, 128), in_channels: int = 3):
        super().__init__()
        c = (in_channels, *channels)
        named(self, "_ConvRBB", [_ConvRBB(c[i], c[i + 1]) for i in range(3)])

    def forward(self, x):
        l1 = self._ConvRBB_0(x)
        l2 = self._ConvRBB_1(l1)
        return l1, l2, self._ConvRBB_2(l2)


class FlowNET(nn.Module):
    """UNet flow estimator: [ref1|ref2] (6ch) -> two flows (4ch). The
    flow-emitting subpel conv starts at zero."""

    def __init__(self):
        super().__init__()
        enc = (6, 32, 64, 128, 192)
        named(self, "_ConvRBB", [_ConvRBB(enc[i], enc[i + 1], blocks=2) for i in range(4)])
        ups = ((192, 128), (128, 64), (64, 32), (32, 4))
        named(self, "ResidualBottleneckBlock",
              [ResidualBottleneckBlock(f) for f, _ in ups for _ in range(2)])
        named(self, "SubpelConv", [SubpelConv(f, o, r=2, zero_init=(o == 4)) for f, o in ups])
        named(self, "Conv", [Conv(2 * o, o, kernel=1) for _, o in ups[:3]])

    def forward(self, x):
        s0 = self._ConvRBB_0(x)
        s1 = self._ConvRBB_1(s0)
        s2 = self._ConvRBB_2(s1)
        x = self._ConvRBB_3(s2)
        for i, skip in enumerate((s2, s1, s0, None)):
            x = getattr(self, f"ResidualBottleneckBlock_{2 * i}")(x)
            x = getattr(self, f"ResidualBottleneckBlock_{2 * i + 1}")(x)
            x = getattr(self, f"SubpelConv_{i}")(x)
            if skip is not None:
                x = getattr(self, f"Conv_{i}")(torch.cat([x, skip], dim=-1))
        return x


class TemporalEnc(nn.Module):
    """Pyramid conditioning encoder -> M-channel temporal prior at /16."""

    def __init__(self, in_channels, N: int = 128, M: int = 128):
        super().__init__()
        c1, c2, c3 = in_channels
        self._ConvRBB_0 = _ConvRBB(c1, N, kernel=5)
        self._ConvRBB_1 = _ConvRBB(N + c2, N, kernel=5)
        self._ConvRBB_2 = _ConvRBB(N + c3, M, kernel=5)

    def forward(self, c1, c2, c3):
        y = self._ConvRBB_0(c1)
        y = self._ConvRBB_1(torch.cat([y, c2], dim=-1))
        return self._ConvRBB_2(torch.cat([y, c3], dim=-1))


class Reconstructor(nn.Module):
    """Top-down fusion of the three compensated scales -> RGB."""

    def __init__(self, channels=(64, 96, 128)):
        super().__init__()
        c1, c2, c3 = channels
        named(self, "ResidualBottleneckBlock",
              [ResidualBottleneckBlock(c) for c in (c3, c2, c1) for _ in range(3)])
        named(self, "SubpelConv",
              [SubpelConv(c3, c3, r=2), SubpelConv(c2, c2, r=2), SubpelConv(c1, 3, r=2)])
        named(self, "Conv", [Conv(c2 + c3, c2, kernel=1), Conv(c1 + c2, c1, kernel=1)])

    def _stage(self, x, i):
        for j in range(3 * i, 3 * i + 3):
            x = getattr(self, f"ResidualBottleneckBlock_{j}")(x)
        return getattr(self, f"SubpelConv_{i}")(x)

    def forward(self, x1, x2, x3):
        l3 = self._stage(x3, 0)
        l2 = self._stage(self.Conv_0(torch.cat([x2, l3], dim=-1)), 1)
        return self._stage(self.Conv_1(torch.cat([x1, l2], dim=-1)), 2)
