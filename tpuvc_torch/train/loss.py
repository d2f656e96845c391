"""Rate-distortion losses (port of tpuvc.train.loss).

LHBDC's objective is alpha * MSE + rate, alpha in ``LHBDC_LAMBDAS``, with a
separate aux loss on the factorized priors' quantiles; ICIP2024's is
beta * 255^2 * MSE + rate, beta in ``ICIP_BETAS``. Rates are in bits per
pixel.
"""

from __future__ import annotations

import torch

#: LHBDC lambda rate points.
LHBDC_LAMBDAS = (228, 436, 845, 1626, 3141)

#: ICIP2023/ICIP2024 beta rate points.
ICIP_BETAS = (0.0056, 0.0107, 0.0207, 0.0400, 0.0772)

#: MS-SSIM rate points: the compressai-convention lambdas for
#: (1 - MS-SSIM) distortion.
MSSSIM_ALPHAS = (2.40, 4.58, 8.73, 16.64, 31.73)


def _mse(x_hat, x):
    return torch.mean((x_hat - x) ** 2)


def _mean(rate):
    """jnp.mean of a rate that may be a tensor or a Python number."""
    return torch.mean(rate) if torch.is_tensor(rate) else float(rate)


def rd_loss(x_hat, x, rate, alpha: float):
    """LHBDC-style: alpha * MSE + rate (rate already in bpp)."""
    mse = _mse(x_hat, x)
    return alpha * mse + _mean(rate), mse


def rd_loss_beta(x_hat, x, rate, beta: float):
    """ICIP-style: beta * 255^2 * MSE + rate."""
    mse = _mse(x_hat, x)
    return beta * (255.0**2) * mse + _mean(rate), mse


def _one_minus_msssim(x_hat, x):
    from tpuvc_torch.eval.metrics import msssim

    return 1.0 - msssim(x_hat, x)


def rd_loss_msssim(x_hat, x, rate, alpha: float):
    """MS-SSIM-optimized RD objective: alpha * (1 - MS-SSIM) + rate. Needs
    crops >= 176 px (5 dyadic scales x 11-tap valid-window SSIM kernel)."""
    d = _one_minus_msssim(x_hat, x)
    return alpha * d + _mean(rate), d


def distortion_fn(name: str):
    """(d(x_hat, x), scale) for the trainer's beta * scale * d + rate form:
    'mse' -> beta * 255^2 * MSE (ICIP convention), 'ms_ssim' ->
    beta * (1 - MS-SSIM)."""
    if name == "ms_ssim":
        return _one_minus_msssim, 1.0
    if name == "mse":
        return _mse, 255.0**2
    raise ValueError(f"unknown distortion: {name}")
