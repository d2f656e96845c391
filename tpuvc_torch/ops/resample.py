"""Resampling ops (port of tpuvc.ops.resample), NHWC.

Bilinear resize is two small matrix products (rows, then columns) with the
same cached interpolation matrices as tpuvc, so the port resamples exactly
the way the reference does, including its align_corners conventions. The
antialiased resize (DMC's fractional down-sampling) is the same two
products over the weights of ``jax.image.resize(..., "linear")``: a
triangle kernel widened by the down-sampling factor.
avg_pool2d with kernel == stride is a reshape-mean; pixel_shuffle is a
reshape/permute.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def avg_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping average pool over H, W (dims -3, -2); H, W divide k."""
    *lead, H, W, C = x.shape
    assert H % k == 0 and W % k == 0, (H, W, k)
    x = x.reshape(*lead, H // k, k, W // k, k, C)
    return x.mean(dim=(-4, -2))


@functools.lru_cache(maxsize=256)
def _resize_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, f32, cached per shape."""
    if n_out == n_in:
        return np.eye(n_in, dtype=np.float32)
    out = np.arange(n_out, dtype=np.float64)
    if align_corners and n_out > 1:
        src = out * (n_in - 1) / (n_out - 1)
    else:
        # Half-pixel-center convention (torch align_corners=False).
        scale = n_in / n_out
        src = np.clip((out + 0.5) * scale - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    m = np.zeros((n_out, n_in), dtype=np.float64)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return m.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _resize_matrix_on(n_in: int, n_out: int, align_corners: bool, device,
                      dtype) -> torch.Tensor:
    """_resize_matrix as a tensor on ``device``, uploaded once: a copy from
    host memory would wait for the device's queue on every call."""
    m = torch.from_numpy(_resize_matrix(n_in, n_out, align_corners))
    return m.to(device=device, dtype=dtype)


def bilinear_resize(
    x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = False
) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., out_h, out_w, C)."""
    H, W = x.shape[-3], x.shape[-2]
    if H == out_h and W == out_w:
        return x
    mh = _resize_matrix_on(H, out_h, align_corners, x.device, x.dtype)
    mw = _resize_matrix_on(W, out_w, align_corners, x.device, x.dtype)
    y = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("pw,...hwc->...hpc", mw, y)


@functools.lru_cache(maxsize=256)
def _antialias_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(..., "linear")`` (its
    ``scale_and_translate`` with ``antialias=True``) along one axis, f32.

    Computed in float32 in jax's order: a triangle kernel at the sample
    positions, widened by 1/scale when down-sampling, each output's weights
    normalised to sum 1 and zeroed where the sample lies outside the input.
    """
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


@functools.lru_cache(maxsize=256)
def _antialias_matrix_on(n_in: int, n_out: int, device, dtype) -> torch.Tensor:
    """_antialias_matrix as a tensor on ``device``, uploaded once."""
    return torch.from_numpy(_antialias_matrix(n_in, n_out)).to(device=device, dtype=dtype)


def resize_antialias(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, (..., out_h, out_w, C), "linear")`` of
    (..., H, W, C): bilinear, antialiased when down-sampling. An axis whose
    size does not change is left as it is, as jax leaves it."""
    H, W = x.shape[-3], x.shape[-2]
    if H != out_h:
        mh = _antialias_matrix_on(H, out_h, x.device, x.dtype)
        x = torch.einsum("oh,...hwc->...owc", mh, x)
    if W != out_w:
        mw = _antialias_matrix_on(W, out_w, x.device, x.dtype)
        x = torch.einsum("pw,...hwc->...hpc", mw, x)
    return x


def upsample2x_flow(flow: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample (align_corners=True) with magnitudes doubled —
    one SPyNet pyramid step."""
    H, W = flow.shape[-3], flow.shape[-2]
    return bilinear_resize(flow, 2 * H, 2 * W, align_corners=True) * 2.0


def upsample_flow(flow: torch.Tensor, factor: int) -> torch.Tensor:
    """xN bilinear upsample (align_corners=False) of flow values, no
    magnitude scaling."""
    H, W = flow.shape[-3], flow.shape[-2]
    return bilinear_resize(flow, factor * H, factor * W, align_corners=False)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W, C*r*r) -> (..., H*r, W*r, C), torch PixelShuffle's
    (c, ry, rx) channel order."""
    *lead, H, W, Crr = x.shape
    C = Crr // (r * r)
    assert C * r * r == Crr
    n = len(lead)
    x = x.reshape(*lead, H, W, C, r, r)
    # (..., H, W, C, ry, rx) -> (..., H, ry, W, rx, C)
    perm = list(range(n)) + [n, n + 3, n + 1, n + 4, n + 2]
    return x.permute(perm).reshape(*lead, H * r, W * r, C)
