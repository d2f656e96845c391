"""SPyNet coarse-to-fine optical flow, the LHBDC motion estimator (port of
tpuvc.models.spynet).

A spatial pyramid where each level refines the upsampled coarse flow with a
five-conv (7x7) block over [frame1, warp(frame2, flow), flow]. The pyramid
halves the frames while a side exceeds 32 px, at most five times; level i
uses block i from the coarsest, and levels past ``num_levels`` reuse the last
block. Every level warps, so one SPyNet call launches the warp kernel once
per pyramid level.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from tpuvc_torch import obs
from tpuvc_torch.models.layers import Conv
from tpuvc_torch.ops.resample import avg_pool2d, upsample2x_flow
from tpuvc_torch.ops.warp import warp


class BasicBlock(nn.Module):
    """Five 7x7 convs: 8 -> 32 -> 64 -> 32 -> 16 -> 2, ReLU between.

    tpuvc stores these kernels as ``conv{i}_kernel``/``conv{i}_bias``; here
    they are ``conv{i}.weight``/``conv{i}.bias``.
    """

    FEATS = (32, 64, 32, 16, 2)

    def __init__(self, in_features: int = 8):
        super().__init__()
        cin = in_features
        for i, co in enumerate(self.FEATS):
            setattr(self, f"conv{i}", Conv(cin, co, kernel=7))
            cin = co

    def forward(self, x, residual=None):
        """The five convs, ReLU in each but the last's epilogue, and
        ``residual`` added in the last's."""
        n = len(self.FEATS)
        for i in range(n - 1):
            x = getattr(self, f"conv{i}")(x, "relu")
        return getattr(self, f"conv{n - 1}")(x, residual=residual)


@functools.lru_cache(maxsize=8)
def _norm_consts(device, dtype):
    """ImageNet mean/std (BGR order reversed) on ``device``, uploaded once
    (as normal tensors even when first asked for under inference mode:
    autograd cannot save inference tensors, and training reuses these)."""
    with torch.inference_mode(False):
        mean = torch.tensor([0.406, 0.456, 0.485], dtype=dtype).to(device)
        std = torch.tensor([0.225, 0.224, 0.229], dtype=dtype).to(device)
    return mean, std


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """Channel-reversed ImageNet normalization (SPyNet expects BGR)."""
    mean, std = _norm_consts(x.device, x.dtype)
    return ((x - mean) / std).flip(-1)


class SPyNet(nn.Module):
    """Estimates flow from ``first`` to ``second`` (sampling second at
    x + flow reconstructs first)."""

    def __init__(self, num_levels: int = 6, warp_compat: str = "lhbdc"):
        super().__init__()
        self.num_levels = num_levels
        self.warp_compat = warp_compat
        for i in range(num_levels):
            setattr(self, f"basic_{i}", BasicBlock())

    @obs.stage
    def forward(self, first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
        assert first.shape == second.shape and first.shape[-1] == 3
        firsts = [preprocess(first)]
        seconds = [preprocess(second)]
        for _ in range(5):
            if firsts[0].shape[-3] > 32 or firsts[0].shape[-2] > 32:
                firsts.insert(0, avg_pool2d(firsts[0], 2))
                seconds.insert(0, avg_pool2d(seconds[0], 2))

        b, h0, w0, _ = firsts[0].shape
        flow = torch.zeros(
            (b, h0 // 2, w0 // 2, 2), dtype=first.dtype, device=first.device
        )
        for level in range(len(firsts)):
            up = upsample2x_flow(flow)
            # Inputs are padded to x64, so pyramid sizes stay even.
            assert up.shape[-3:-1] == firsts[level].shape[-3:-1], (
                up.shape, firsts[level].shape,
            )
            warped = warp(seconds[level], up, compat=self.warp_compat)
            inp = torch.cat([firsts[level], warped, up], dim=-1)
            block = getattr(self, f"basic_{min(level, self.num_levels - 1)}")
            flow = block(inp, residual=up)
        return flow
