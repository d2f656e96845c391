"""Distortion metrics (port of tpuvc.eval.metrics).

PSNR follows the evaluation protocol: uint8-rounded RGB over the unpadded
crop. ``psnr_uint8`` rounds on the tensors' device, so only a scalar moves;
``psnr_uint8_np`` is its host twin for frames already on the host.
``msssim`` is the standard 5-scale MS-SSIM (Wang et al. weights) with a
separable 11-tap gaussian blur over the valid window, so each side must be
at least 176 px.
"""

from __future__ import annotations

import numpy as np
import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(mse_val, data_range: float = 1.0):
    return 10.0 * torch.log10(data_range**2 / mse_val)


def _round_uint8(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint8:
        # Already in the uint8 domain: clipping against [0, 1] would
        # binarize the frame.
        return x.float()
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0)


def psnr_uint8(ref, dec) -> torch.Tensor:
    """PSNR between uint8-rounded frames; takes [0, 1] floats or uint8
    tensors (or numpy arrays), like psnr_uint8_np."""
    m = torch.mean((_round_uint8(torch.as_tensor(ref)) - _round_uint8(torch.as_tensor(dec))) ** 2)
    return psnr(m, data_range=255.0)


def psnr_uint8_np(ref: np.ndarray, dec: np.ndarray) -> float:
    """Host (numpy) twin of psnr_uint8: [0, 1] floats or uint8 arrays, the
    same rounding; the MSE is floored at 1e-12."""

    def r(x):
        if x.dtype == np.uint8:
            return x.astype(np.float64)
        return np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.float64)

    m = np.mean((r(ref) - r(dec)) ** 2)
    return float(10.0 * np.log10(255.0**2 / max(m, 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _ssim_components(a, b, k1=0.01, k2=0.03, data_range=1.0):
    """Per-level SSIM mean and contrast-structure mean for NHWC inputs."""
    import torch.nn.functional as F

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    C = a.shape[-1]
    g = torch.from_numpy(_gaussian_kernel()).to(a.device)
    k = g.shape[0]
    wh = g.reshape(1, 1, k, 1).expand(C, 1, k, 1)
    ww = g.reshape(1, 1, 1, k).expand(C, 1, 1, k)

    def blur2(x):
        # (B, H, W, C) -> valid-window gaussian blur, separable, depthwise.
        x = x.permute(0, 3, 1, 2)
        x = F.conv2d(F.conv2d(x, wh, groups=C), ww, groups=C)
        return x.permute(0, 2, 3, 1)

    mu_a = blur2(a)
    mu_b = blur2(b)
    saa = blur2(a * a) - mu_a**2
    sbb = blur2(b * b) - mu_b**2
    sab = blur2(a * b) - mu_a * mu_b
    cs = (2 * sab + c2) / (saa + sbb + c2)
    ssim = ((2 * mu_a * mu_b + c1) / (mu_a**2 + mu_b**2 + c1)) * cs
    return torch.mean(ssim), torch.mean(cs)


_MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], np.float32)


def _pad_edge_to_even(x: torch.Tensor) -> torch.Tensor:
    """Repeat the last row / column of (B, H, W, C) where H / W is odd."""
    if x.shape[-3] % 2:
        x = torch.cat([x, x[:, -1:]], dim=-3)
    if x.shape[-2] % 2:
        x = torch.cat([x, x[:, :, -1:]], dim=-2)
    return x


def msssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM (5 scales, Wang et al. weights), NHWC in [0, 1],
    computed in float32 (the blur is a float32 convolution: TF32 must be
    off, as :func:`tpuvc_torch.ops.precision.set_deterministic` sets)."""
    from tpuvc_torch.ops.resample import avg_pool2d

    a, b = a.float(), b.float()
    vals = []
    for i in range(5):
        s, cs = _ssim_components(a, b, data_range=data_range)
        vals.append(s if i == 4 else cs)
        if i < 4:
            a = avg_pool2d(_pad_edge_to_even(a), 2)
            b = avg_pool2d(_pad_edge_to_even(b), 2)
    out = torch.ones((), device=a.device)
    for w, v in zip(_MSSSIM_WEIGHTS, vals):
        # Clamp away from 0: the contrast-structure term can go negative on
        # uncorrelated inputs, and v**w has an infinite gradient at 0.
        out = out * torch.maximum(v, torch.full_like(v, 1e-6)) ** float(w)
    return out
