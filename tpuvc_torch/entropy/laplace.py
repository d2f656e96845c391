"""Scale-indexed zero-mean Laplace conditional coder, the DMC P-frame
codec's latent coder (port of tpuvc.entropy.laplace).

The same structure as :class:`tpuvc_torch.entropy.gaussian.GaussianConditional`
(the 64-level exponential scale table for the rANS bucket index, the same
quantized CDF build) with the Laplace CDF in place of the normal CDF. Table
building is numpy, so both packages build equal tables.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvc_torch.entropy.emath import LIKELIHOOD_BOUND, lower_bound
from tpuvc_torch.entropy.gaussian import GaussianConditional, GaussianTables


def _lap_cdf(t: torch.Tensor) -> torch.Tensor:
    """Standard Laplace CDF at t = x / scale.

    Each branch's exponent is clamped to its own side of 0: the values are
    tpuvc's, and so is the gradient wherever tpuvc's is finite. tpuvc's
    ``where(t < 0, 0.5 exp(t), 1 - 0.5 exp(-t))`` overflows the branch it
    does not select once |t| > 88, and that inf times the zero gradient
    ``where`` hands the branch is NaN (a latent ~10 scales from its mean)."""
    return torch.where(t < 0, 0.5 * torch.exp(torch.clamp(t, max=0.0)),
                       1.0 - 0.5 * torch.exp(-torch.clamp(t, min=0.0)))


class LaplaceConditional(GaussianConditional):
    """GaussianConditional's interface and scale-table indexing
    (``__call__``, ``build_indexes``) over a zero-mean Laplace distribution."""

    def likelihood(self, y_hat: torch.Tensor, scales: torch.Tensor,
                   means=None) -> torch.Tensor:
        """P(y_hat in [y-0.5, y+0.5]) under Laplace(means, scales) per element."""
        v = y_hat if means is None else y_hat - means
        v = torch.abs(v)
        s = lower_bound(scales, self.scale_bound)
        upper = _lap_cdf((0.5 - v) / s)
        lower = _lap_cdf((-0.5 - v) / s)
        return lower_bound(upper - lower, LIKELIHOOD_BOUND)

    def build_tables(self, precision: int = 16) -> GaussianTables:
        """Quantized Laplace CDFs over [-m, m] per table scale."""
        from tpuvc_torch.entropy.cdf import build_cdf_table

        # Laplace quantile: P(|X| > m) = exp(-m/b) -> m = -b*ln(tail).
        multiplier = -np.log(self.tail_mass)
        centers = np.ceil(self.scale_table * multiplier).astype(np.int64)
        lengths = 2 * centers + 1
        max_len = int(lengths.max())
        n = len(self.scale_table)
        pmf = np.zeros((n, max_len), dtype=np.float64)
        tails = np.zeros(n, dtype=np.float64)

        def cdf(x, b):
            return np.where(
                x < 0, 0.5 * np.exp(x / b), 1.0 - 0.5 * np.exp(-x / b)
            )

        for i, (scale, c) in enumerate(zip(self.scale_table, centers)):
            x = np.arange(-c, c + 1, dtype=np.float64)
            pmf[i, : lengths[i]] = cdf(x + 0.5, scale) - cdf(x - 0.5, scale)
            tails[i] = 2.0 * cdf(-(c + 0.5), scale)
        cdfs, cdf_lengths = build_cdf_table(pmf, lengths, tails, precision)
        return GaussianTables(
            cdfs=cdfs,
            cdf_lengths=np.asarray(cdf_lengths, np.int32),
            offsets=(-centers).astype(np.int32),
        )
