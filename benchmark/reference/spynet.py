"""SPyNet coarse-to-fine optical flow (LHBDC's motion estimator): a
pyramid halving while a side exceeds 32 px (at most five times), each level
refining the upsampled flow with five 7x7 convs over [frame1, warp(frame2),
flow]."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv
from .resample import avg_pool2d, upsample2x_flow
from .warp import warp


class BasicBlock(nn.Module):
    FEATS = (32, 64, 32, 16, 2)

    def __init__(self, in_features: int = 8):
        super().__init__()
        cin = in_features
        for i, co in enumerate(self.FEATS):
            setattr(self, f"conv{i}", Conv(cin, co, kernel=7))
            cin = co

    def forward(self, x):
        n = len(self.FEATS)
        for i in range(n):
            x = getattr(self, f"conv{i}")(x)
            if i < n - 1:
                x = F.relu(x)
        return x


def preprocess(x):
    """Channel-reversed ImageNet normalisation (SPyNet expects BGR)."""
    mean = torch.tensor([0.406, 0.456, 0.485], dtype=x.dtype).to(x.device)
    std = torch.tensor([0.225, 0.224, 0.229], dtype=x.dtype).to(x.device)
    return ((x - mean) / std).flip(-1)


class SPyNet(nn.Module):
    def __init__(self, num_levels: int = 6, warp_compat: str = "lhbdc"):
        super().__init__()
        self.num_levels = num_levels
        self.warp_compat = warp_compat
        for i in range(num_levels):
            setattr(self, f"basic_{i}", BasicBlock())

    def forward(self, first, second):
        firsts, seconds = [preprocess(first)], [preprocess(second)]
        for _ in range(5):
            if firsts[0].shape[-3] > 32 or firsts[0].shape[-2] > 32:
                firsts.insert(0, avg_pool2d(firsts[0], 2))
                seconds.insert(0, avg_pool2d(seconds[0], 2))
        b, h0, w0, _ = firsts[0].shape
        flow = torch.zeros((b, h0 // 2, w0 // 2, 2), dtype=first.dtype, device=first.device)
        for level in range(len(firsts)):
            up = upsample2x_flow(flow)
            warped = warp(seconds[level], up, compat=self.warp_compat)
            block = getattr(self, f"basic_{min(level, self.num_levels - 1)}")
            flow = block(torch.cat([firsts[level], warped, up], dim=-1)) + up
        return flow
