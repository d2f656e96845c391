"""Pad-to-multiple / crop for NHWC frame tensors (port of tpuvc.ops.pad).

Padding goes on the bottom and right only, keeping pixel (0, 0) anchored.
``reflect`` follows numpy's (and so ``jnp.pad``'s) semantics, including pads
wider than the input, which repeat the reflection: the LHBDC codec pads /4
flows of small frames by more than their own size. ``F.pad`` refuses those,
so the padding is an index gather. ``constant`` pads with zeros.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_index(n: int, pad: int, mode: str, device) -> torch.Tensor:
    i = torch.arange(n + pad, device=device)
    if mode == "edge":
        return i.clamp(max=n - 1)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        i = i % period
        return torch.where(i < n, i, period - i)
    raise ValueError(f"unsupported pad mode: {mode}")


def pad_to_multiple(x: torch.Tensor, multiple: int = 64, mode: str = "reflect"):
    """Pad H and W (dims -3, -2) up to the next multiple.

    Returns (padded, (orig_h, orig_w)). ``mode`` is 'reflect' (torch
    ReflectionPad2d / numpy reflect), 'edge' (replicate) or 'constant'
    (zeros).
    """
    h, w = x.shape[-3], x.shape[-2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph == 0 and pw == 0:
        return x, (h, w)
    if mode == "constant":
        return F.pad(x, (0, 0, 0, pw, 0, ph)), (h, w)
    x = x.index_select(-3, _pad_index(h, ph, mode, x.device))
    x = x.index_select(-2, _pad_index(w, pw, mode, x.device))
    return x, (h, w)


def unpad(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Crop H, W (dims -3, -2) back to ``size`` = (h, w)."""
    h, w = size
    return x[..., :h, :w, :]
