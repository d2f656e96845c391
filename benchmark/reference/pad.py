"""Bottom/right padding to a multiple (numpy-style reflect or zeros) and
the crop back."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reflect_index(n: int, pad: int, device):
    i = torch.arange(n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i < n, i, period - i)


def pad_to_multiple(x, multiple: int = 64, mode: str = "reflect"):
    h, w = x.shape[-3], x.shape[-2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph == 0 and pw == 0:
        return x, (h, w)
    if mode == "constant":
        return F.pad(x, (0, 0, 0, pw, 0, ph)), (h, w)
    x = x.index_select(-3, _reflect_index(h, ph, x.device))
    x = x.index_select(-2, _reflect_index(w, pw, x.device))
    return x, (h, w)


def unpad(x, size):
    h, w = size
    return x[..., :h, :w, :]
