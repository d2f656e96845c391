"""Distortion metrics (port of tpuvc.eval.metrics' PSNR functions).

PSNR follows the evaluation protocol: uint8-rounded RGB over the unpadded
crop. ``psnr_uint8`` rounds on the tensors' device, so only a scalar moves;
``psnr_uint8_np`` is its host twin for frames already on the host.
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
