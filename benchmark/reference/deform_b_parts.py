"""DeformB's parts that FlowGuidedB's reference lacks: the conditional ELIC
bottlenecks with drawn gain vectors, the residual bottleneck's pixel-level
analysis stage, and the reconstructor with transposed convolutions.

- :class:`GainedCondELIC`: :class:`reference.cond_elic.CondELIC` whose four
  gain vectors are drawn per level and channel (U(0.8, 1.25)), where the
  published model starts them at one: at a rate level between two levels
  the geometric interpolation then mixes two different vectors.
- :class:`PixelCondELIC`: the same, with ``g_a0`` (conv 5x5 stride 2 and
  three residual bottleneck blocks over the raw current frame) folded into
  the first analysis stage beside the /2 conditions.
- :class:`ReconstructorDeconv`: the top-down reconstructor of
  :class:`reference.ms_feature.Reconstructor` with kernel-3, stride-2
  transposed convolutions (``Deconv_0..2``) in place of the subpel convs.
"""

from __future__ import annotations

import torch
from torch import nn

from . import entropy as E
from .checkerboard import keep_anchor
from .cond_elic import CondELIC
from .elic import code_groups
from .layers import Conv, Deconv, ResidualBottleneckBlock, named
from .ms_feature import Reconstructor, _ConvRBB

#: the range of the drawn gains
GAIN_RANGE = (0.8, 1.25)


class GainedCondELIC(CondELIC):
    @torch.no_grad()
    def reset_parameters(self, draws=None):
        super().reset_parameters(draws)
        if draws is not None:
            for g in (self.Gain, self.InverseGain, self.HyperGain, self.InverseHyperGain):
                draws.uniform(g, *GAIN_RANGE)


class PixelCondELIC(GainedCondELIC):
    """``in_channels`` are the widths of the three pyramid inputs; the
    first analysis stage takes ``g_a0``'s N channels beside the first."""

    def __init__(self, head_channels, in_channels, cond_channels, temporal_channels: int,
                 N: int = 128, M: int = 128, levels: int = 5, groups=(6, 6, 12, 24, 80)):
        a1, a2, a3 = in_channels
        super().__init__(head_channels, (N + a1, a2, a3), cond_channels, temporal_channels,
                         N=N, M=M, levels=levels, groups=groups)
        self.g_a0 = _ConvRBB(3, N, kernel=5)

    def analysis(self, c1, c2, c3, s, x_pixel=None):
        return super().analysis(torch.cat([self.g_a0(x_pixel), c1], dim=-1), c2, c3, s)

    def encode(self, inputs, conds, temporal_cond, s, x_pixel=None):
        """The coder's stream path -> (heads, bits (B,), y_hat, z_hat)."""
        y, z = self.analysis(*inputs, s, x_pixel=x_pixel)
        med = self.entropy_bottleneck.medians()
        z_hat = E.symbols(z, med) + med
        y_hat, y_bits = code_groups(self, y, self.hyper_params(z_hat, temporal_cond, s))
        bits = y_bits + E.bits(self.entropy_bottleneck.likelihood(z_hat))
        return self.synthesis(y_hat, *conds, s), bits, y_hat, z_hat

    def forward_eval(self, inputs, conds, temporal_cond, s, x_pixel=None):
        """The eval's likelihood pass (mode 'dequantize'; the contexts
        rounded plainly) -> (heads, bits (B,), round(y))."""
        y, z = self.analysis(*inputs, s, x_pixel=x_pixel)
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


class ReconstructorDeconv(Reconstructor):
    """Top-down fusion of the three compensated scales -> RGB, upsampling
    by transposed convolutions."""

    def __init__(self, channels=(64, 128, 192)):
        nn.Module.__init__(self)
        c1, c2, c3 = channels
        named(self, "ResidualBottleneckBlock",
              [ResidualBottleneckBlock(c) for c in (c3, c2, c1) for _ in range(3)])
        named(self, "Deconv", [Deconv(c3, c3, kernel=3, stride=2),
                               Deconv(c2, c2, kernel=3, stride=2),
                               Deconv(c1, 3, kernel=3, stride=2)])
        named(self, "Conv", [Conv(c2 + c3, c2, kernel=1), Conv(c1 + c2, c1, kernel=1)])

    def _stage(self, x, i):
        for j in range(3 * i, 3 * i + 3):
            x = getattr(self, f"ResidualBottleneckBlock_{j}")(x)
        return getattr(self, f"Deconv_{i}")(x)
