"""UNets (port of tpuvc.models.unet).

- MaskUNet: the LHBDC occlusion mask, a 3-down/3-up conv UNet over the two
  warped predictions with a sigmoid single-channel output and bilinear x2
  upsampling in the decoder;
- UNet: the Flex-Rate flow predictor and blend mask, ``depth`` levels of
  widths 2**(wf+i), leaky-ReLU 0.1, avg-pool down, bilinear x2 up and skip
  concatenation.
"""

from __future__ import annotations

import torch
from torch import nn

from tpuvc_torch.models.layers import Conv, leaky_relu
from tpuvc_torch.models.ms_feature import _named
from tpuvc_torch.ops.resample import bilinear_resize


def _maxpool2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _up2(x):
    return bilinear_resize(x, 2 * x.shape[-3], 2 * x.shape[-2], align_corners=False)


class MaskUNet(nn.Module):
    """Occlusion mask over [fw, bw] warped frames -> sigmoid mask in (0,1)."""

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
        c1 = self.Conv_0(x, "relu")
        x = _maxpool2(c1)
        c2 = self.Conv_1(x, "relu")
        x = _maxpool2(c2)
        c3 = self.Conv_2(x, "relu")
        x = _maxpool2(c3)
        x = self.Conv_3(x, "relu")
        x = torch.cat([_up2(x), c3], dim=-1)
        x = self.Conv_4(x, "relu")
        x = torch.cat([_up2(x), c2], dim=-1)
        x = self.Conv_5(x, "relu")
        x = torch.cat([_up2(x), c1], dim=-1)
        x = self.Conv_6(x, "relu")
        return torch.sigmoid(self.Conv_7(x))


def _avgpool2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


#: The UNet's leaky-ReLU slope.
SLOPE = 0.1


def _lrelu(x):
    return leaky_relu(x, SLOPE)


class UNet(nn.Module):
    """UNet with ``depth`` levels of widths 2**(wf+i): two 3x3 convs a level,
    avg-pool down, a mid conv, then per level up a bilinear x2 upsample,
    a 3x3 conv, the skip concatenated and two 3x3 convs; a final 3x3 conv.
    Its convs are ``Conv_0..`` in tpuvc's (flax's) creation order."""

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
            convs += [Conv(cin, w, kernel=3), Conv(2 * w, w, kernel=3),
                      Conv(w, w, kernel=3)]
            cin = w
        convs.append(Conv(cin, out_channels, kernel=3))
        self.n_convs = len(convs)
        _named(self, "Conv", convs)

    def forward(self, x):
        convs = iter(getattr(self, f"Conv_{i}") for i in range(self.n_convs))
        skips = []
        for i in range(self.depth):
            x = next(convs)(x, "leaky_relu", SLOPE)
            x = next(convs)(x, "leaky_relu", SLOPE)
            if i < self.depth - 1:
                skips.append(x)
                x = _avgpool2(x)
        x = next(convs)(x, "leaky_relu", SLOPE)
        for i in reversed(range(self.depth - 1)):
            x = torch.cat([next(convs)(_up2(x)), skips[i]], dim=-1)
            x = next(convs)(x, "leaky_relu", SLOPE)
            x = next(convs)(x, "leaky_relu", SLOPE)
        return next(convs)(x)
