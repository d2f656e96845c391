"""Checkerboard context of the ELIC-style entropy models: anchor cells are
those with (row + col) odd; the masked 5x5 context conv sees only anchors;
context parameters are zeroed at anchors."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import lecun_normal_


def anchor_mask(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 1) float mask, 1 at anchor cells."""
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return torch.from_numpy(((ii + jj) % 2 == 1).astype(np.float32))[..., None].to(device)


def keep_anchor(x):
    return x * anchor_mask(x.shape[-3], x.shape[-2], x.device)


def keep_non_anchor(x):
    return x * (1.0 - anchor_mask(x.shape[-3], x.shape[-2], x.device))


class CheckerboardConv(nn.Module):
    """k x k conv over checkerboard-offset taps only, in float32."""

    def __init__(self, in_features: int, features: int, kernel: int = 5):
        super().__init__()
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features))
        ii, jj = np.meshgrid(np.arange(kernel), np.arange(kernel), indexing="ij")
        self.register_buffer("mask", torch.from_numpy(((ii + jj) % 2 == 1).astype(np.float32)),
                             persistent=False)

    @torch.no_grad()
    def reset_parameters(self, draws=None):
        lecun_normal_(self.weight, draws)
        self.bias.zero_()

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight * self.mask, padding=self.kernel // 2)
        return y.permute(0, 2, 3, 1) + self.bias
