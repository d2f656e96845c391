"""Offset-diversity deformable fusion of the two warped references (port of
tpuvc.models.offset_diversity).

Per reference, the decoded head (27*8 = 216 channels) splits into two 72-
channel offset halves and a 72-channel mask; offsets are tanh-bounded by a
per-scale magnitude and centred on the scaled flow; one grouped (2*8)
modulated deformable conv fuses both references' features into one
compensated map.
"""

from __future__ import annotations

import torch
from torch import nn

from tpuvc_torch import obs
from tpuvc_torch.ops.deform import DeformConv

DEFORM_GROUPS = 8  # per reference; the fusion uses 2 * 8


class OffsetDiversity(nn.Module):
    """``features``: width of each reference's features and of the output."""

    def __init__(self, features: int, magnitude: float):
        super().__init__()
        self.magnitude = magnitude
        self.DeformConv_0 = DeformConv(
            2 * features, features, groups=2 * DEFORM_GROUPS, kernel=3
        )

    def _prep(self, head, flow):
        """head (B,H,W,216) -> (offsets (B,H,W,144), masks (B,H,W,72)).

        Offsets are (dy, dx) pairs per tap (torchvision's layout); the flow
        (dx, dy) is the centre of every tap, and the tanh-bounded prediction
        is the diversity around it.
        """
        o1, o2, mask = torch.chunk(head, 3, dim=-1)
        offset = torch.tanh(torch.cat([o1, o2], dim=-1)) * self.magnitude
        n_taps = offset.shape[-1] // 2
        offset = offset + flow.flip(-1).repeat(1, 1, 1, n_taps)
        return offset, torch.sigmoid(mask)

    @obs.stage
    def forward(self, x1, head1, flow1, x2, head2, flow2):
        off1, m1 = self._prep(head1, flow1)
        off2, m2 = self._prep(head2, flow2)
        return self.DeformConv_0(
            torch.cat([x1, x2], dim=-1),
            torch.cat([off1, off2], dim=-1),
            torch.cat([m1, m2], dim=-1),
        )
