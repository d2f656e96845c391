"""Entropy models: quantization, the Gaussian conditional's and the
factorized prior's likelihoods, bits. Plain float32."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LIKELIHOOD_BOUND = 1e-9
SCALE_MIN = 0.11


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return torch.clamp_min(x, bound)


def symbols(x, means=None):
    """The coder's int16-clamped integer symbols round(x - means) as float."""
    centered = x if means is None else x - means
    return torch.clamp(torch.round(centered), -32000, 32000)


def dequantize(x, means=None):
    """round(x - means) + means (inference)."""
    q = torch.round(x if means is None else x - means)
    return q if means is None else q + means


def bits(likelihoods: torch.Tensor) -> torch.Tensor:
    """(B,) sum(-log2 p) over all but the batch dim."""
    p = lower_bound(likelihoods, LIKELIHOOD_BOUND)
    return torch.sum(torch.log(p), dim=tuple(range(1, p.dim()))) / (-math.log(2.0))


def _std_cumulative(x):
    return 0.5 * torch.special.erfc(-x * (2**-0.5))


def gaussian_likelihood(y_hat, scales, means=None):
    """P(y_hat in [y - 0.5, y + 0.5]) under N(means, scales^2)."""
    v = torch.abs(y_hat if means is None else y_hat - means)
    s = lower_bound(scales, SCALE_MIN)
    return lower_bound(_std_cumulative((0.5 - v) / s) - _std_cumulative((-0.5 - v) / s),
                       LIKELIHOOD_BOUND)


class FactorizedBottleneck(nn.Module):
    """Per-channel monotone-MLP CDF (Balle et al. 2018, appendix 6.1)."""

    def __init__(self, channels: int, filters: tuple[int, ...] = (3, 3, 3, 3),
                 init_scale: float = 10.0):
        super().__init__()
        self.channels = channels
        self.filters = tuple(filters)
        self.init_scale = init_scale
        dims = (1,) + self.filters + (1,)
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.register_parameter(
                f"matrix_{i}", nn.Parameter(torch.empty(channels, dims[i + 1], dims[i])))
            self.register_parameter(
                f"bias_{i}", nn.Parameter(torch.empty(channels, dims[i + 1], 1)))
            if i < self.n_layers - 1:
                self.register_parameter(
                    f"factor_{i}", nn.Parameter(torch.empty(channels, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3))

    @torch.no_grad()
    def reset_parameters(self, draws=None):
        dims = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1.0 / self.n_layers)
        for i in range(self.n_layers):
            getattr(self, f"matrix_{i}").fill_(float(np.log(np.expm1(1.0 / scale / dims[i + 1]))))
            if draws is not None:
                draws.uniform(getattr(self, f"bias_{i}"), -0.5, 0.5)
            if i < self.n_layers - 1:
                getattr(self, f"factor_{i}").zero_()
        q = torch.tensor([-self.init_scale, 0.0, self.init_scale], device=self.quantiles.device)
        self.quantiles.copy_(q.expand(self.channels, 1, 3))

    def logits_cumulative(self, x):
        logits = x
        for i in range(self.n_layers):
            logits = torch.matmul(F.softplus(getattr(self, f"matrix_{i}")), logits) \
                + getattr(self, f"bias_{i}")
            if i < self.n_layers - 1:
                logits = logits + torch.tanh(getattr(self, f"factor_{i}")) * torch.tanh(logits)
        return logits

    def likelihood(self, y_hat):
        shape = y_hat.shape
        flat = y_hat.reshape(-1, shape[-1]).t()[:, None, :]
        lower = self.logits_cumulative(flat - 0.5)
        upper = self.logits_cumulative(flat + 0.5)
        sign = -torch.sign(lower + upper)
        lik = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        return lower_bound(lik, LIKELIHOOD_BOUND)[:, 0, :].t().reshape(shape)

    def medians(self):
        return self.quantiles[:, 0, 1]
