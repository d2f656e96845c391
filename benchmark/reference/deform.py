"""Modulated deformable convolution (torchvision's ``deform_conv2d``
semantics), NHWC, in plain PyTorch: every output pixel samples its K*K
taps at p + tap base + offset, bilinear with zero padding outside the
frame, times its mask, contracted with its group's weights; the bias
after. :data:`CALLS` records (x shape, weight shape, groups) of each call
while a counting pass runs."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from .layers import lecun_normal_

CALLS: list | None = None


@contextlib.contextmanager
def recording(calls: list):
    global CALLS
    CALLS = calls
    try:
        yield calls
    finally:
        CALLS = None


def _sample_zero_pad(img, flow):
    B, H, W, C = img.shape
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)
    x = xs[None, None, :] + flow[..., 0]
    y = ys[None, :, None] + flow[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = img.reshape(B * H * W, C)
    base = torch.arange(B, device=img.device).view(B, 1, 1) * (H * W)

    def corner(yi, xi, w):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.clamp(xi, 0, W - 1).long()
        yc = torch.clamp(yi, 0, H - 1).long()
        v = flat.index_select(0, (base + yc * W + xc).reshape(-1)).reshape(B, H, W, C)
        return v * (w * valid)[..., None]

    return (corner(y0, x0, (1 - fy) * (1 - fx)) + corner(y0, x0 + 1, (1 - fy) * fx)
            + corner(y0 + 1, x0, fy * (1 - fx)) + corner(y0 + 1, x0 + 1, fy * fx))


def deform_conv2d(x, offsets, masks, weight, bias, groups: int, kernel: int = 3):
    """x (B,H,W,C); offsets (B,H,W,G*K*K*2) as (dy, dx) per (group, tap),
    tap k = ky*K + kx; masks (B,H,W,G*K*K); weight (C_out, C//G, K, K)."""
    if CALLS is not None:
        CALLS.append((tuple(x.shape), tuple(weight.shape), groups))
    B, H, W, C = x.shape
    K, G = kernel, groups
    T = K * K
    Cg = C // G
    C_out = weight.shape[0]
    Og = C_out // G
    xg = x.reshape(B, H, W, G, Cg).permute(0, 3, 1, 2, 4).reshape(B * G, H, W, Cg)
    off = offsets.reshape(B, H, W, G, T, 2).permute(0, 3, 1, 2, 4, 5).reshape(B * G, H, W, T, 2)
    m = masks.reshape(B, H, W, G, T).permute(0, 3, 1, 2, 4).reshape(B * G, H, W, T)
    wk = weight.reshape(G, Og, Cg, T).permute(3, 2, 0, 1)
    pad = K // 2
    acc = torch.zeros((B, G, H, W, Og), dtype=x.dtype, device=x.device)
    for k in range(T):
        ky, kx = divmod(k, K)
        flow = torch.stack([off[..., k, 1] + (kx - pad), off[..., k, 0] + (ky - pad)], dim=-1)
        sampled = (_sample_zero_pad(xg, flow) * m[..., k][..., None]).reshape(B, G, H, W, Cg)
        acc = acc + torch.einsum("bghwc,cgo->bghwo", sampled, wk[k])
    return acc.permute(0, 2, 3, 1, 4).reshape(B, H, W, C_out) + bias


class DeformConv(nn.Module):
    def __init__(self, in_features: int, features: int, groups: int = 8, kernel: int = 3):
        super().__init__()
        self.groups = groups
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def reset_parameters(self, draws=None):
        lecun_normal_(self.weight, draws)
        self.bias.zero_()

    def forward(self, x, offsets, masks):
        return deform_conv2d(x, offsets, masks, self.weight, self.bias, self.groups, self.kernel)
