"""Sequence evaluation loops (port of tpuvc.eval.runner): walk the coding
order, code I and B frames, track PSNR and size, keep the decoded picture
buffer.

- I-frames go through the intra codec, B-frames through the inter codec with
  the two nearest decoded references;
- PSNR on uint8-rounded RGB over the unpadded (h, w) crop;
- size in bits (from likelihoods), bpp normalized by h*w;
- decoded frames clamped to [0, 1] before entering the DPB.

Frames stay on the device; each frame's PSNR (and MS-SSIM) is computed as a
device scalar and the whole sequence's scalars come to the host in one
transfer at its end. ``eval_sequence_lowdelay`` is the low-delay loop of
the DMC P-frame codec: I-frames every ``intra_period``, chained P-frames in
between, each through the decoded-picture-buffer dict.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from tpuvc_torch import obs
from tpuvc_torch.eval.infographic import TestInfographic
from tpuvc_torch.eval.metrics import msssim, psnr_uint8
from tpuvc_torch.gop.dpb import DecodedPictureBuffer


def _fetch(columns: list[list]) -> list[np.ndarray]:
    """One device-to-host transfer for several equal-length columns of
    float32 device scalars: -> one float32 array per column."""
    device = columns[0][0].device
    stacked = torch.stack([
        torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device) for v in col])
        for col in columns
    ])
    return list(stacked.cpu().numpy())


def eval_sequence(
    frames,
    order_list: list[int],
    typ_list: list[str],
    intra_fn: Callable,
    inter_fn: Callable,
    crop_hw: tuple[int, int],
    video: str = "",
    level: int = 0,
    info: TestInfographic | None = None,
    dpb_capacity: int = 32,
    compute_msssim: bool = False,
):
    """Evaluate one sequence at one rate level.

    Args:
      frames: indexable of (1, H, W, 3) padded device tensors (or a loader
        object with __getitem__ returning them lazily).
      intra_fn(x) -> (x_hat, size_bits)
      inter_fn(ref1, ref2, xcur, order, order1, order2) -> (x_hat, size_bits)
      crop_hw: original (h, w) for PSNR/bpp accounting.

    Returns (psnr_list, size_list) indexed by display order.
    """
    h, w = crop_hw
    n = len(order_list)
    psnr_list = [0.0] * n
    size_list = [0.0] * n
    dpb = DecodedPictureBuffer(capacity=dpb_capacity)

    pending: list = []
    for order in order_list:
        frame = frames[order]
        if typ_list[order] == "I":
            dec, size = intra_fn(frame)
        else:
            ref1, ref2, order1, order2 = dpb.select_references(order)
            dec, size = inter_fn(ref1, ref2, frame, order, order1, order2)

        p_dev = psnr_uint8(frame[:, :h, :w], dec[:, :h, :w])
        ms_dev = None
        if compute_msssim:
            ms_dev = msssim(frame[:, :h, :w], torch.clamp(dec[:, :h, :w], 0, 1))
        pending.append((order, p_dev, size, ms_dev))
        dpb.add(torch.clamp(dec, 0.0, 1.0), order)

    if not pending:
        return psnr_list, size_list
    columns = [[p for _, p, _, _ in pending], [s for _, _, s, _ in pending]]
    if compute_msssim:
        columns.append([m for _, _, _, m in pending])
    ps, szs, *mss = _fetch(columns)
    for k, (order, _, _, _) in enumerate(pending):
        psnr_list[order] = float(ps[k])
        size_list[order] = float(szs[k])
        extra = {"msssim": float(mss[0][k])} if mss else {}
        if info is not None:
            info.update(
                video, level, order, typ_list[order], psnr_list[order],
                size_list[order], h * w, **extra,
            )
    return psnr_list, size_list


def eval_sequence_lowdelay(
    frames,
    n_frames: int,
    intra_period: int,
    intra_fn: Callable,
    pframe_fn: Callable,
    crop_hw: tuple[int, int],
    ratio_for_frame: Callable | None = None,
    video: str = "",
    level: int = 0,
    info: TestInfographic | None = None,
    diagnostics=None,
    compute_msssim: bool = False,
):
    """Low-delay P-frame evaluation: I every ``intra_period`` frames, every
    other frame a P chained through the decoded-picture-buffer dict.

    Args:
      intra_fn(x) -> (x_hat, size_bits)
      pframe_fn(x, dpb, ratio) -> (x_hat, size_bits, new_dpb, extras)
        with extras optionally carrying "warp_psnr"/"bits_mv"/"bits_y"
        for the per-frame diagnostics ledger.
      ratio_for_frame(x, dpb) -> down ratio (the fractional search with
        hysteresis); None -> ratio 1.0 everywhere.
      diagnostics: optional tpuvc_torch.eval.results_io.PerFrameDiagnostics.

    Returns (psnr_list, size_list) in display order.
    """
    h, w = crop_hw
    dpb = None
    # The adaptive ratio search is the only data-dependent host decision
    # in the loop; the per-frame metrics are fetched once at the end.
    pending: list = []
    for i in range(n_frames):
        frame = frames[i]
        extras: dict = {}
        if i % intra_period == 0:
            dec, size = intra_fn(frame)
            dec = torch.clamp(dec, 0.0, 1.0)
            dpb = {"ref_frame": dec, "ref_feature": None, "ref_down_ratio": 1.0}
            typ, ratio = "I", 1.0
        else:
            ratio = ratio_for_frame(frame, dpb) if ratio_for_frame is not None else 1.0
            dec, size, dpb, extras = pframe_fn(frame, dpb, ratio)
            typ = "P"
        p_dev = psnr_uint8(frame[:, :h, :w], dec[:, :h, :w])
        ms_dev = None
        if compute_msssim:
            ms_dev = msssim(frame[:, :h, :w], torch.clamp(dec[:, :h, :w], 0, 1))
        pending.append((typ, ratio, p_dev, size, ms_dev, extras))

    if not pending:
        return [], []
    columns = [[p for _, _, p, _, _, _ in pending], [s for _, _, _, s, _, _ in pending]]
    if compute_msssim:
        columns.append([m for _, _, _, _, m, _ in pending])
    ps, szs, *mss = _fetch(columns)
    psnr_list: list[float] = []
    size_list: list[float] = []
    for i, (typ, ratio, _, _, _, extras) in enumerate(pending):
        p, size = float(ps[i]), float(szs[i])
        psnr_list.append(p)
        size_list.append(size)
        extra = {"msssim": float(mss[0][i])} if mss else {}
        if info is not None:
            info.update(video, level, i, typ, p, size, h * w, **extra)
        if diagnostics is not None:
            conv = lambda v: None if v is None else float(v)  # noqa: E731
            diagnostics.update(
                frame=i, type=typ, down_ratio=ratio, psnr=p,
                warp_psnr=conv(extras.get("warp_psnr")), bits=size,
                bpp=size / (h * w), bits_mv=conv(extras.get("bits_mv")),
                bits_y=conv(extras.get("bits_y")),
            )
    return psnr_list, size_list


def summarize(psnr_list, size_list, crop_hw):
    h, w = crop_hw
    return {
        "psnr": float(np.mean(psnr_list)),
        "bpp": float(np.mean(size_list) / (h * w)),
    }


@obs.spanned("eval")
def eval_sequence_batched(
    frames,
    n_frames: int,
    gop: int,
    intra_fn: Callable,
    inter_fn_batched: Callable,
    crop_hw: tuple[int, int],
    video: str = "",
    level: int = 0,
    info: TestInfographic | None = None,
    max_batch: int | None = None,
    compute_msssim: bool = False,
    window_gops: int = 1,
):
    """Level-batched sequence evaluation: the performance path.

    Codes the sequence GOP by GOP with tpuvc_torch.gop.scheduler's
    level-batched forwards (independent frames within a hierarchy level
    share one batched call). Covers the largest ``k*gop + 1`` prefix of the
    sequence; the caller decides how to treat any tail (the sequential
    ``eval_sequence`` is the full-protocol path).

    Args:
      inter_fn_batched(ref1 (B,H,W,3), ref2, xcur, idxs, refs) ->
        (x_hat (B,H,W,3), sizes (B,)) with idxs/refs in GOP-local orders.

    window_gops > 1 enables CROSS-GOP level batching: the same hierarchy
    level of up to that many consecutive GOPs is coded in one batched
    forward (code_gops_batched). Reconstructions equal the per-GOP
    schedule's; only the batching changes.

    Returns (psnr_list, size_list) in display order over the covered
    prefix.
    """
    from tpuvc_torch.gop.order import gop_coding_table
    from tpuvc_torch.gop.scheduler import code_gops_batched

    h, w = crop_hw
    n_use = ((n_frames - 1) // gop) * gop + 1
    if n_use < gop + 1:
        raise ValueError(f"need at least one full GOP, got {n_frames} frames")
    table = gop_coding_table(gop)

    psnr_list: list[float] = [0.0] * n_use
    size_list: list[float] = [0.0] * n_use

    # Metrics are computed per frame and fetched once per sequence; only
    # device scalars stay alive in between.
    pending: list = []

    def record(idx, typ, dec, size, src=None):
        # src: the scheduler's device slice of the source frame, so PSNR
        # needs no second upload.
        frame = src if src is not None else frames[idx]
        p_dev = psnr_uint8(frame[:, :h, :w], dec[:, :h, :w])
        ms_dev = None
        if compute_msssim:
            ms_dev = msssim(frame[:, :h, :w], torch.clamp(dec[:, :h, :w], 0, 1))
        pending.append((idx, typ, p_dev, size, ms_dev))

    prev_anchor = None
    window = max(1, window_gops) * gop
    for w0 in range(0, n_use - 1, window):
        starts = list(range(w0, min(w0 + window, n_use - 1), gop))
        anchors: dict = {}
        for b in [w0] + [g + gop for g in starts]:
            if b == w0 and prev_anchor is not None:
                anchors[b] = prev_anchor
                continue
            x = frames[b]
            with obs.span("intra", batch=1):
                dec, s = intra_fn(x)
            dec = torch.clamp(dec, 0.0, 1.0)
            anchors[b] = dec
            record(b, "I", dec, s)

        srcs: dict = {}
        decoded, sizes = code_gops_batched(
            frames, anchors, table, inter_fn_batched, starts,
            max_batch=max_batch, sources=srcs,
        )
        for f, bits in sizes.items():
            record(f, "B", decoded[f], bits, src=srcs.get(f))
        prev_anchor = anchors[starts[-1] + gop]

    if pending:
        columns = [[p for _, _, p, _, _ in pending]]
        if compute_msssim:
            columns.append([m for _, _, _, _, m in pending])
        ps, *mss = _fetch(columns)
        # Sizes: host floats from the scheduler for B-frames; I-frames'
        # device scalars (a few) are read one by one, as in tpuvc.
        for k, (idx, typ, _, size, _) in enumerate(pending):
            p = float(ps[k])
            size = float(size)
            psnr_list[idx] = p
            size_list[idx] = size
            extra = {"msssim": float(mss[0][k])} if mss else {}
            if info is not None:
                info.update(video, level, idx, typ, p, size, h * w, **extra)
    return psnr_list, size_list
