"""Low-delay P-frame sequence evaluation with content-adaptive ratios (port
of tpuvc.eval.pframe_runner).

An I-frame through the intra codec, then chained P-frames; each P-frame
first runs the fractional down-ratio search with hysteresis toward the
previous frame's ratio, then codes at the chosen ratio, carrying the DPB
dict. A thin adapter over :func:`tpuvc_torch.eval.runner.eval_sequence_lowdelay`
for the DMC model's output dict and a raw warp-prediction function.
"""

from __future__ import annotations

from collections.abc import Callable

from tpuvc_torch.eval.results_io import PerFrameDiagnostics
from tpuvc_torch.gop.adaptive import OJSP_RATIOS, fractional_ratio_search


def eval_pframe_sequence(
    frames,
    n_frames: int,
    intra_fn: Callable,
    pframe_fn: Callable,
    warp_pred_fn: Callable,
    crop_hw: tuple[int, int],
    intra_period: int = 32,
    ratios=OJSP_RATIOS,
    diagnostics: PerFrameDiagnostics | None = None,
):
    """Low-delay evaluation.

    intra_fn(x) -> (x_hat, bits)
    pframe_fn(x, dpb, ratio) -> dict(x_hat, bits, dpb, ...)
    warp_pred_fn(x, ref_frame, ratio) -> the warp-only prediction frame.
    """
    from tpuvc_torch.eval.runner import eval_sequence_lowdelay

    last_search: dict = {}

    def ratio_for_frame(x, dpb):
        ratio, warp_psnr, _ = fractional_ratio_search(
            lambda r: warp_pred_fn(x, dpb["ref_frame"], r),
            x,
            prev_ratio=dpb["ref_down_ratio"],
            ratios=ratios,
        )
        last_search["warp_psnr"] = warp_psnr
        return ratio

    def pf(x, dpb, ratio):
        out = pframe_fn(x, dpb, ratio)
        # Device scalars; the runner fetches them once at the end.
        extras = (
            {k: out[k] for k in ("bits_mv", "bits_y") if k in out}
            if diagnostics is not None
            else {}
        )
        if "warp_psnr" in last_search:
            extras["warp_psnr"] = last_search.pop("warp_psnr")
        return out["x_hat"], out["bits"], out["dpb"], extras

    return eval_sequence_lowdelay(
        frames, n_frames, intra_period, intra_fn, pf, crop_hw,
        ratio_for_frame=ratio_for_frame, diagnostics=diagnostics,
    )
