"""Content-adaptive inference: the motion-adaptive down-ratio searches
(port of tpuvc.gop.adaptive).

- v4 integer-ratio search (``best_down_ratio_prediction``): ratios
  {1, 2, 4, 8, 16}, argmax of the flow-only prediction's PSNR; and its RD
  variant (``best_down_ratio_rd``), argmin of beta * MSE + rate over full
  codec passes.
- OJSP fractional-ratio search with hysteresis
  (``fractional_ratio_search``): 32 ratios 1..8.75 step 0.25, the same
  argmax, and a 0.1 dB bias toward the previous frame's ratio (keep the old
  ratio unless the new best beats it by more than the bias).

Every search dispatches all of its candidates on the device first and then
makes one host transfer of their stacked scores; the choice is a numpy
argmax over that array, so ties break toward the earlier candidate exactly
as in tpuvc.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import numpy as np
import torch

V4_RATIOS = (1, 2, 4, 8, 16)
OJSP_RATIOS = tuple(np.arange(1.0, 9.0, 0.25))
OJSP_BIAS = 0.1


def psnr_of(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((torch.clamp(pred, 0.0, 1.0) - target) ** 2)
    return 10.0 * torch.log10(1.0 / mse)


def _fetch(scores: list) -> np.ndarray:
    """One device-to-host transfer of the stacked candidate scores."""
    return torch.stack(scores).cpu().numpy()


def best_down_ratio_prediction(
    predict: Callable[[int], torch.Tensor],
    xcur: torch.Tensor,
    ratios: Sequence[int] = V4_RATIOS,
):
    """v4 search: argmax PSNR of the flow-only prediction.

    ``predict(ratio)`` returns the flow-only compensated frame.
    Returns (best_ratio, best_psnr).
    """
    ps = _fetch([psnr_of(predict(r), xcur) for r in ratios])
    best = int(np.argmax(ps))
    return ratios[best], float(ps[best])


def best_down_ratio_rd(
    evaluate: Callable[[int], tuple[torch.Tensor, torch.Tensor]],
    xcur: torch.Tensor,
    beta: float,
    ratios: Sequence[int] = V4_RATIOS,
):
    """v4 RD variant: argmin beta * MSE + rate over full codec passes.

    ``evaluate(ratio)`` returns (x_hat, rate). Returns (best_ratio, loss).
    """
    losses = []
    for ratio in ratios:
        x_hat, rate = evaluate(ratio)
        losses.append(beta * torch.mean((x_hat - xcur) ** 2) + torch.mean(rate))
    losses = _fetch(losses)
    best = int(np.argmin(losses))
    return ratios[best], float(losses[best])


def fractional_ratio_search(
    predict: Callable[[float], torch.Tensor],
    xcur: torch.Tensor,
    prev_ratio: float | None,
    ratios: Sequence[float] = OJSP_RATIOS,
    bias: float = OJSP_BIAS,
):
    """OJSP search with hysteresis.

    ``predict(ratio)`` returns the motion-compensated frame at that ratio.
    If the best candidate beats the previous frame's ratio by less than
    ``bias`` dB, the previous ratio is kept (temporal stability of the MV
    statistics).

    Returns (chosen_ratio, chosen_psnr, best_psnr).
    """
    ps = _fetch([psnr_of(predict(r), xcur) for r in ratios])
    best = int(np.argmax(ps))
    best_ratio, best_psnr = ratios[best], float(ps[best])
    prev_psnr = None
    if prev_ratio is not None:
        for i, ratio in enumerate(ratios):
            if ratio == prev_ratio:
                prev_psnr = float(ps[i])
                break
    if (
        prev_ratio is not None
        and prev_psnr is not None
        and (best_psnr - prev_psnr) < bias
        and prev_ratio != best_ratio
    ):
        return prev_ratio, prev_psnr, best_psnr
    return best_ratio, best_psnr, best_psnr
