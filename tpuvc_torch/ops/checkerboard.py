"""Checkerboard spatial-context helpers of the ELIC entropy models (port of
tpuvc.ops.checkerboard).

- anchor cells are those with (row + col) odd;
- the masked 5x5 context conv sees only anchor cells;
- context parameters are zeroed at anchor positions (anchors use the hyper
  and channel context only).

The row and column are the frame's: rows ``[y0, y0 + h)`` of a frame (a
rank's rows of an H-sharded latent, tpuvc_torch.parallel.spatial) take the
masks with ``y0``, whose parity flips them where y0 is odd.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuvc_torch.models.layers import lecun_normal_


@functools.lru_cache(maxsize=64)
def _anchor_mask_np(h: int, w: int, parity: int = 0) -> np.ndarray:
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return ((ii + jj + parity) % 2 == 1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _anchor_mask_on(h: int, w: int, device, parity: int = 0) -> torch.Tensor:
    """The (h, w, 1) mask on ``device``, uploaded once (a normal tensor even
    under inference mode: training's autograd saves it)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_anchor_mask_np(h, w, parity))[..., None].to(device)


def anchor_mask(h: int, w: int, y0: int = 0) -> torch.Tensor:
    """(h, w) float mask on the CPU, 1 at anchor cells ((row + col) odd) of
    rows ``[y0, y0 + h)``."""
    return torch.from_numpy(_anchor_mask_np(h, w, y0 % 2))


def keep_anchor(x: torch.Tensor, y0: int = 0) -> torch.Tensor:
    """Zero the non-anchor cells of (..., H, W, C) (the context conv's input),
    the rows being rows ``[y0, y0 + H)`` of the frame."""
    return x * _anchor_mask_on(x.shape[-3], x.shape[-2], x.device, y0 % 2)


def keep_non_anchor(x: torch.Tensor, y0: int = 0) -> torch.Tensor:
    """Zero the anchor cells of (..., H, W, C) (the context conv's output),
    the rows being rows ``[y0, y0 + H)`` of the frame."""
    return x * (1.0 - _anchor_mask_on(x.shape[-3], x.shape[-2], x.device, y0 % 2))


def checkerboard_kernel_mask(k: int = 5) -> np.ndarray:
    """(k, k) mask, 1 where (i + j) odd: the masked conv's taps."""
    ii, jj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    return ((ii + jj) % 2 == 1).astype(np.float32)


class CheckerboardConv(nn.Module):
    """k x k conv whose kernel taps only checkerboard-offset neighbours.

    The mask multiplies the dense kernel at every call, as in tpuvc. The
    conv runs in float32 whatever the compute-dtype policy, as tpuvc's does.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 5):
        super().__init__()
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features))
        mask = torch.from_numpy(checkerboard_kernel_mask(kernel))
        self.register_buffer("mask", mask, persistent=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        lecun_normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight * self.mask,
                     padding=self.kernel // 2)
        return y.permute(0, 2, 3, 1) + self.bias
