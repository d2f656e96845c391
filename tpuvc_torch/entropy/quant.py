"""Quantization surrogates for training and inference (port of
tpuvc.entropy.quant). ``torch.round`` rounds half to even, as ``jnp.round``."""

from __future__ import annotations

import torch


class RowNoise:
    """A noise source for one data-parallel rank: it draws for the whole
    batch of ``total`` rows from ``generator`` and hands out rows
    ``[start, start + b)``, so the rank adds its rows of the noise a
    one-process step adds (tpuvc_torch.train.trainer.data_parallel)."""

    def __init__(self, generator: torch.Generator, total: int, start: int):
        self.generator, self.total, self.start = generator, total, start

    def rand(self, shape, device, dtype) -> torch.Tensor:
        full = torch.rand((self.total, *shape[1:]), generator=self.generator,
                          device=device, dtype=dtype)
        return full[self.start : self.start + shape[0]]


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through (identity) gradient."""
    return x + (torch.round(x) - x).detach()


def quantize(
    x: torch.Tensor,
    mode: str,
    means: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Quantize ``x``.

    mode:
      'noise'      — add U(-0.5, 0.5) (training surrogate; needs a generator
                     on x's device, or a :class:`RowNoise`).
      'ste'        — straight-through round of (x - means) + means.
      'dequantize' — hard round of (x - means) + means (inference).
      'symbols'    — integer symbols round(x - means) (for the coder).
      'symbols16'  — same, int16-clamped (narrow device->host fetch).
    """
    if mode == "noise":
        if generator is None:
            raise ValueError("noise quantization needs a torch.Generator")
        if isinstance(generator, RowNoise):
            noise = generator.rand(x.shape, x.device, x.dtype)
        else:
            noise = torch.rand(
                x.shape, generator=generator, device=x.device, dtype=x.dtype
            )
        return x + (noise - 0.5)
    centered = x if means is None else x - means
    if mode == "symbols":
        return torch.round(centered).to(torch.int32)
    if mode == "symbols16":
        # The clamp binds only on degenerate statistics; encoder and decoder
        # reconstruct from the SAME clamped symbol, so round trips stay exact.
        s = torch.round(centered)
        return torch.clamp(s, -32000, 32000).to(torch.int16)
    if mode == "ste":
        q = ste_round(centered)
    elif mode == "dequantize":
        q = torch.round(centered)
    else:
        raise ValueError(f"unknown quantize mode: {mode}")
    return q if means is None else q + means
