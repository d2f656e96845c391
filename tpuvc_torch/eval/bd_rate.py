"""Bjontegaard-delta metrics (BD-rate / BD-PSNR); the port's copy of
tpuvc.eval.bd_rate (numpy and scipy only).

A cubic polynomial fit in log-rate, with optional piecewise-cubic (pchip)
integration, and the anchor curves the reference publishes.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate


def bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test, piecewise: bool = False):
    """Average PSNR gain of test over anchor across the overlapping rates."""
    lr_a = np.log(np.asarray(rate_anchor, dtype=np.float64))
    lr_t = np.log(np.asarray(rate_test, dtype=np.float64))
    pa = np.asarray(psnr_anchor, dtype=np.float64)
    pt = np.asarray(psnr_test, dtype=np.float64)

    min_int = max(lr_a.min(), lr_t.min())
    max_int = min(lr_a.max(), lr_t.max())
    if piecewise:
        int_a = _pchip_integral(lr_a, pa, min_int, max_int)
        int_t = _pchip_integral(lr_t, pt, min_int, max_int)
    else:
        int_a = _poly_integral(lr_a, pa, min_int, max_int)
        int_t = _poly_integral(lr_t, pt, min_int, max_int)
    return (int_t - int_a) / (max_int - min_int)


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test, piecewise: bool = False):
    """Average rate change (%) of test vs anchor at equal quality.

    Negative = test saves rate over the anchor.
    """
    lr_a = np.log(np.asarray(rate_anchor, dtype=np.float64))
    lr_t = np.log(np.asarray(rate_test, dtype=np.float64))
    pa = np.asarray(psnr_anchor, dtype=np.float64)
    pt = np.asarray(psnr_test, dtype=np.float64)

    min_int = max(pa.min(), pt.min())
    max_int = min(pa.max(), pt.max())
    if piecewise:
        int_a = _pchip_integral(pa, lr_a, min_int, max_int, sort_x=True)
        int_t = _pchip_integral(pt, lr_t, min_int, max_int, sort_x=True)
    else:
        int_a = _poly_integral(pa, lr_a, min_int, max_int)
        int_t = _poly_integral(pt, lr_t, min_int, max_int)
    avg_exp_diff = (int_t - int_a) / (max_int - min_int)
    return (np.exp(avg_exp_diff) - 1) * 100.0


def _poly_integral(x, y, lo, hi):
    p = np.polyfit(x, y, 3)
    pi = np.polyint(p)
    return np.polyval(pi, hi) - np.polyval(pi, lo)


def _pchip_integral(x, y, lo, hi, sort_x: bool = False):
    x = np.asarray(x)
    y = np.asarray(y)
    order = np.argsort(x)
    x, y = x[order], y[order]
    interp = scipy.interpolate.PchipInterpolator(x, y)
    return interp.integrate(lo, hi)


# Anchor curves of the reference (ICIP2023's and ICIP2024's training
# BD-rate); values are published RD points.
ANCHORS = {
    "elfvc": (
        [0.04, 0.06, 0.08, 0.10, 0.16, 0.2, 0.28],
        [35.6, 36.50, 37.10, 37.60, 38.40, 38.8, 39.40],
    ),
    "flex_icip2022": (
        [0.0593, 0.0773, 0.0911, 0.1056, 0.1297, 0.1432, 0.1581, 0.2030],
        [36.38, 37.11, 37.44, 37.70, 38.12, 38.30, 38.47, 38.85],
    ),
    "lhbdc": (
        [0.0587, 0.0781, 0.1147, 0.1549, 0.2250, 0.2749],
        [35.43, 36.27, 37.30, 37.92, 38.69, 39.04],
    ),
    "icip2024_train": (
        [0.04654, 0.06355, 0.10168, 0.15951, 0.25624],
        [35.996, 36.900, 37.819, 38.650, 39.415],
    ),
}
