"""Shared entropy-model math (port of tpuvc.entropy.emath).

``lower_bound`` is max(x, bound) whose gradient passes where the input is at
or above the bound, or where the gradient pushes it up (compressai's
LowerBound). ``clip`` is ``jnp.clip`` with JAX's gradient. Bits are
sum(-log2 p).
"""

from __future__ import annotations

import math

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x >= bound)
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (pass_through,) = ctx.saved_tensors
        return torch.where(pass_through | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return _LowerBound.apply(x, bound)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``torch.clamp``'s values, and JAX's gradient,
    which is half the incoming one where x sits exactly on a bound
    (``torch.clamp`` passes all of it). ``torch.maximum`` and
    ``torch.minimum`` with tensor bounds split a tie as JAX does."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


#: Floor applied to likelihoods before taking logs (compressai default).
LIKELIHOOD_BOUND = 1e-9


def likelihood_to_bits(likelihoods: torch.Tensor) -> torch.Tensor:
    """Total information content in bits: sum(-log2 p)."""
    p = lower_bound(likelihoods, LIKELIHOOD_BOUND)
    return torch.sum(torch.log(p)) / (-math.log(2.0))


def per_sample_bits(likelihoods: torch.Tensor) -> torch.Tensor:
    """(B,) bits per batch element: sum(-log2 p) over all non-batch dims."""
    p = lower_bound(likelihoods, LIKELIHOOD_BOUND)
    dims = tuple(range(1, p.dim()))
    return torch.sum(torch.log(p), dim=dims) / (-math.log(2.0))
