"""Multi-scale feature pipeline of the v4 codec (port of tpuvc.models.ms_feature).

- MSFeature: three strided stages, /2, /4 and /8 feature pyramids;
- FlowNET: 4-down/4-up UNet over the concatenated references, a 4-channel
  flow pair at its input resolution;
- TemporalEnc: pyramid encoder of conditioning features to an M-channel
  prior at /16;
- Reconstructor: top-down fusion of the three compensated scales to RGB
  (v4's subpel variant); ReconstructorDeconv: the same with kernel-3
  transposed convs (v3).

flax infers input widths from the data; here each module is told them.
Submodule names are tpuvc's flax auto-names (``_ConvRBB_0``,
``ResidualBottleneckBlock_2``, ``SubpelConv_0``, ``Conv_1``).
"""

from __future__ import annotations

import torch
from torch import nn

from tpuvc_torch import obs
from tpuvc_torch.models.layers import Conv, Deconv, ResidualBottleneckBlock, SubpelConv


def _named(module: nn.Module, prefix: str, items) -> None:
    for i, m in enumerate(items):
        setattr(module, f"{prefix}_{i}", m)


class _ConvRBB(nn.Module):
    """conv (k, s) followed by ``blocks`` residual bottleneck blocks."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 2, blocks: int = 3):
        super().__init__()
        self.blocks = blocks
        self.Conv_0 = Conv(in_features, features, kernel=kernel, stride=stride)
        _named(self, "ResidualBottleneckBlock",
               [ResidualBottleneckBlock(features) for _ in range(blocks)])

    def forward(self, x):
        x = self.Conv_0(x)
        for i in range(self.blocks):
            x = getattr(self, f"ResidualBottleneckBlock_{i}")(x)
        return x


class MSFeature(nn.Module):
    """Three strided stages producing /2, /4, /8 feature pyramids."""

    def __init__(self, channels: tuple[int, int, int] = (64, 96, 128),
                 in_channels: int = 3):
        super().__init__()
        c = (in_channels, *channels)
        _named(self, "_ConvRBB", [_ConvRBB(c[i], c[i + 1]) for i in range(3)])

    @obs.stage
    def forward(self, x):
        l1 = self._ConvRBB_0(x)
        l2 = self._ConvRBB_1(l1)
        l3 = self._ConvRBB_2(l2)
        return l1, l2, l3


class FlowNET(nn.Module):
    """UNet flow estimator: in [ref1|ref2] (6ch), out 4ch (two flows). The
    flow-emitting subpel conv starts at zero, as tpuvc's."""

    def __init__(self):
        super().__init__()
        enc = (6, 32, 64, 128, 192)
        _named(self, "_ConvRBB",
               [_ConvRBB(enc[i], enc[i + 1], blocks=2) for i in range(4)])
        # up(x, feat, out): 2 RBB(feat) -> SubpelConv(out), then a 1x1 fuse
        # with the skip of the same scale.
        ups = ((192, 128), (128, 64), (64, 32), (32, 4))
        _named(self, "ResidualBottleneckBlock",
               [ResidualBottleneckBlock(f) for f, _ in ups for _ in range(2)])
        _named(self, "SubpelConv",
               [SubpelConv(f, o, r=2, zero_init=(o == 4)) for f, o in ups])
        _named(self, "Conv", [Conv(2 * o, o, kernel=1) for _, o in ups[:3]])

    @obs.stage
    def forward(self, x):
        s0 = self._ConvRBB_0(x)
        s1 = self._ConvRBB_1(s0)
        s2 = self._ConvRBB_2(s1)
        s3 = self._ConvRBB_3(s2)
        x = s3
        for i, skip in enumerate((s2, s1, s0, None)):
            x = getattr(self, f"ResidualBottleneckBlock_{2 * i}")(x)
            x = getattr(self, f"ResidualBottleneckBlock_{2 * i + 1}")(x)
            x = getattr(self, f"SubpelConv_{i}")(x)
            if skip is not None:
                x = getattr(self, f"Conv_{i}")(torch.cat([x, skip], dim=-1))
        return x


class TemporalEnc(nn.Module):
    """Pyramid conditioning encoder -> M-channel temporal prior at /16.
    ``in_channels`` are the widths of its three conditioning inputs."""

    def __init__(self, in_channels: tuple[int, int, int], N: int = 128, M: int = 128):
        super().__init__()
        c1, c2, c3 = in_channels
        self._ConvRBB_0 = _ConvRBB(c1, N, kernel=5)
        self._ConvRBB_1 = _ConvRBB(N + c2, N, kernel=5)
        self._ConvRBB_2 = _ConvRBB(N + c3, M, kernel=5)

    @obs.stage
    def forward(self, c1, c2, c3):
        y = self._ConvRBB_0(c1)
        y = self._ConvRBB_1(torch.cat([y, c2], dim=-1))
        return self._ConvRBB_2(torch.cat([y, c3], dim=-1))


class Reconstructor(nn.Module):
    """Top-down decoder fusing the 3 compensated scales -> RGB (v4 subpel)."""

    UP = "SubpelConv"  # name of the x2 upsampling layers

    def __init__(self, channels: tuple[int, int, int] = (64, 96, 128)):
        super().__init__()
        c1, c2, c3 = channels
        _named(self, "ResidualBottleneckBlock",
               [ResidualBottleneckBlock(c) for c in (c3, c2, c1) for _ in range(3)])
        _named(self, self.UP, self._ups(c1, c2, c3))
        _named(self, "Conv", [Conv(c2 + c3, c2, kernel=1), Conv(c1 + c2, c1, kernel=1)])

    @staticmethod
    def _ups(c1, c2, c3):
        return [SubpelConv(c3, c3, r=2), SubpelConv(c2, c2, r=2), SubpelConv(c1, 3, r=2)]

    def _stage(self, x, i):
        for j in range(3 * i, 3 * i + 3):
            x = getattr(self, f"ResidualBottleneckBlock_{j}")(x)
        return getattr(self, f"{self.UP}_{i}")(x)

    @obs.stage
    def forward(self, x1, x2, x3):
        l3 = self._stage(x3, 0)
        l2 = self._stage(self.Conv_0(torch.cat([x2, l3], dim=-1)), 1)
        l1 = self.Conv_1(torch.cat([x1, l2], dim=-1))
        return self._stage(l1, 2)


class ReconstructorDeconv(Reconstructor):
    """v3's variant: kernel-3, stride-2 transposed convs (``Deconv_0..2``) in
    place of the subpel convs."""

    UP = "Deconv"

    def __init__(self, channels: tuple[int, int, int] = (32, 64, 96)):
        super().__init__(channels)

    @staticmethod
    def _ups(c1, c2, c3):
        return [Deconv(c3, c3, kernel=3, stride=2), Deconv(c2, c2, kernel=3, stride=2),
                Deconv(c1, 3, kernel=3, stride=2)]
