"""LHBDC's occlusion-mask UNet and FlowGuidedB's flow UNet."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, leaky_relu, named
from .resample import bilinear_resize


def _maxpool2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _avgpool2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _up2(x):
    return bilinear_resize(x, 2 * x.shape[-3], 2 * x.shape[-2], align_corners=False)


class MaskUNet(nn.Module):
    """[fw, bw] warped frames -> sigmoid blend mask."""

    def __init__(self, in_features: int = 6, ch: int = 32):
        super().__init__()
        self.Conv_0 = Conv(in_features, ch, kernel=5)
        self.Conv_1 = Conv(ch, ch * 2, kernel=5)
        self.Conv_2 = Conv(ch * 2, ch * 4, kernel=3)
        self.Conv_3 = Conv(ch * 4, ch * 4, kernel=3)
        self.Conv_4 = Conv(ch * 8, ch * 4, kernel=3)
        self.Conv_5 = Conv(ch * 4 + ch * 2, ch * 2, kernel=5)
        self.Conv_6 = Conv(ch * 2 + ch, ch, kernel=5)
        self.Conv_7 = Conv(ch, 1, kernel=5)

    def forward(self, x):
        c1 = F.relu(self.Conv_0(x))
        x = _maxpool2(c1)
        c2 = F.relu(self.Conv_1(x))
        x = _maxpool2(c2)
        c3 = F.relu(self.Conv_2(x))
        x = _maxpool2(c3)
        x = F.relu(self.Conv_3(x))
        x = F.relu(self.Conv_4(torch.cat([_up2(x), c3], dim=-1)))
        x = F.relu(self.Conv_5(torch.cat([_up2(x), c2], dim=-1)))
        x = F.relu(self.Conv_6(torch.cat([_up2(x), c1], dim=-1)))
        return torch.sigmoid(self.Conv_7(x))


def _lrelu(x):
    return leaky_relu(x, 0.1)


class UNet(nn.Module):
    """``depth`` levels of widths 2**(wf+i): two 3x3 convs a level, avg-pool
    down, a mid conv; per level up a x2 upsample, a 3x3 conv, the skip, two
    3x3 convs; a final 3x3 conv."""

    def __init__(self, in_features: int, out_channels: int = 4, depth: int = 5,
                 wf: int = 5):
        super().__init__()
        self.depth = depth
        convs, cin = [], in_features
        for i in range(depth):
            w = 2 ** (wf + i)
            convs += [Conv(cin, w, kernel=3), Conv(w, w, kernel=3)]
            cin = w
        convs.append(Conv(cin, 2 ** (wf + depth - 1), kernel=3))
        cin = 2 ** (wf + depth - 1)
        for i in reversed(range(depth - 1)):
            w = 2 ** (wf + i)
            convs += [Conv(cin, w, kernel=3), Conv(2 * w, w, kernel=3), Conv(w, w, kernel=3)]
            cin = w
        convs.append(Conv(cin, out_channels, kernel=3))
        self.n_convs = len(convs)
        named(self, "Conv", convs)

    def forward(self, x):
        convs = iter(getattr(self, f"Conv_{i}") for i in range(self.n_convs))
        skips = []
        for i in range(self.depth):
            x = _lrelu(next(convs)(x))
            x = _lrelu(next(convs)(x))
            if i < self.depth - 1:
                skips.append(x)
                x = _avgpool2(x)
        x = _lrelu(next(convs)(x))
        for i in reversed(range(self.depth - 1)):
            x = torch.cat([next(convs)(_up2(x)), skips[i]], dim=-1)
            x = _lrelu(next(convs)(x))
            x = _lrelu(next(convs)(x))
        return next(convs)(x)
