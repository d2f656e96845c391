"""Bilinear backward warp, NHWC, border clamp, in plain PyTorch.

``compat``: ``exact`` samples img[y + dy, x + dx]; ``lhbdc`` scales the
displacement by W/(W-1), H/(H-1) (LHBDC's grid_sample normalisation).
:data:`CALLS` records each call's shape while a counting pass runs
(:func:`recording`), for the benchmark's byte and operation counts.
"""

from __future__ import annotations

import contextlib

import torch

CALLS: list | None = None


@contextlib.contextmanager
def recording(calls: list):
    global CALLS
    CALLS = calls
    try:
        yield calls
    finally:
        CALLS = None


def warp(img, flow, compat: str = "exact"):
    B, H, W, C = img.shape
    if CALLS is not None:
        CALLS.append((tuple(img.shape), tuple(flow.shape)))
    sx, sy = (W / (W - 1.0), H / (H - 1.0)) if compat == "lhbdc" else (1.0, 1.0)
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)
    x = torch.clamp(xs[None, None, :] + flow[..., 0] * sx, 0.0, W - 1.0)
    y = torch.clamp(ys[None, :, None] + flow[..., 1] * sy, 0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    flat = img.reshape(B * H * W, C)
    base = torch.arange(B, device=img.device).view(B, 1, 1) * (H * W)

    def at(yi, xi):
        return flat.index_select(0, (base + yi * W + xi).reshape(-1)).reshape(B, H, W, C)

    return ((1 - fy) * (1 - fx) * at(y0i, x0i) + (1 - fy) * fx * at(y0i, x1i)
            + fy * (1 - fx) * at(y1i, x0i) + fy * fx * at(y1i, x1i))
