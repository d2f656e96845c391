"""Resampling, NHWC: non-overlapping average pool, bilinear resize as two
interpolation-matrix products, flow upsampling, pixel shuffle."""

from __future__ import annotations

import numpy as np
import torch


def avg_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    *lead, H, W, C = x.shape
    return x.reshape(*lead, H // k, k, W // k, k, C).mean(dim=(-4, -2))


def resize_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation weights."""
    if n_out == n_in:
        return np.eye(n_in, dtype=np.float32)
    out = np.arange(n_out, dtype=np.float64)
    if align_corners and n_out > 1:
        src = out * (n_in - 1) / (n_out - 1)
    else:
        src = np.clip((out + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    m = np.zeros((n_out, n_in), dtype=np.float64)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return m.astype(np.float32)


def bilinear_resize(x, out_h: int, out_w: int, align_corners: bool = False):
    H, W = x.shape[-3], x.shape[-2]
    if H == out_h and W == out_w:
        return x
    mh = torch.from_numpy(resize_matrix(H, out_h, align_corners)).to(x.device)
    mw = torch.from_numpy(resize_matrix(W, out_w, align_corners)).to(x.device)
    y = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("pw,...hwc->...hpc", mw, y)


def upsample2x_flow(flow):
    H, W = flow.shape[-3], flow.shape[-2]
    return bilinear_resize(flow, 2 * H, 2 * W, align_corners=True) * 2.0


def upsample_flow(flow, factor: int):
    H, W = flow.shape[-3], flow.shape[-2]
    return bilinear_resize(flow, factor * H, factor * W, align_corners=False)


def pixel_shuffle(x, r: int):
    """(..., H, W, C*r*r) -> (..., H*r, W*r, C) in (c, ry, rx) channel order."""
    *lead, H, W, Crr = x.shape
    C = Crr // (r * r)
    n = len(lead)
    x = x.reshape(*lead, H, W, C, r, r)
    perm = list(range(n)) + [n, n + 3, n + 1, n + 4, n + 2]
    return x.permute(perm).reshape(*lead, H * r, W * r, C)
