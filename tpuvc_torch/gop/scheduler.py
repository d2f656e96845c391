"""Level-batched GOP scheduling (port of tpuvc.gop.scheduler).

The hierarchical B-levels of a GOP form a dependency DAG: frames within one
hierarchy level depend only on frames from shallower levels, so they are
independent and can be coded as ONE batched forward. For GOP-16 that turns
15 sequential B-frame forwards into 4 batched ones (batch 1, 2, 4, 8).

The sequential runner (tpuvc_torch.eval.runner.eval_sequence) remains the
protocol path; this scheduler is the performance path and gives the same
reconstructions and per-frame sizes.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from tpuvc_torch import obs
from tpuvc_torch.gop.order import GopTable


def _fetch_sizes(pending: list, key) -> dict:
    """One device-to-host transfer of every chunk's per-frame sizes:
    {key(chunk item): bits}."""
    if not pending:
        return {}
    flat = torch.cat([torch.as_tensor(s).reshape(-1) for _, s in pending]).cpu().tolist()
    items = [key(item) for chunk, _ in pending for item in chunk]
    return dict(zip(items, flat))


def code_gops_batched(
    frames,
    i_frames: dict,
    table: GopTable,
    inter_fn_batched: Callable,
    gop_starts: list[int],
    max_batch: int | None = None,
    sources: dict | None = None,
):
    """Code several GOPs with CROSS-GOP level batching.

    Hierarchy levels only order frames *within* a GOP; the same level of
    different GOPs shares no dependencies, so a window of G GOPs runs every
    level at batch G * level_width instead of level_width.

    Args:
      frames: indexable by ABSOLUTE frame index.
      i_frames: {absolute index: decoded I} for every window boundary
        (g and g+gop for each g in gop_starts).
      inter_fn_batched: as in code_gop_batched; idxs/refs stay GOP-local,
        which is well-defined across GOPs because a hierarchy level has the
        same local geometry in every GOP.
      gop_starts: absolute start index of each GOP in the window.
      sources: optional dict the coder fills with {absolute frame_idx:
        device source slice}, so callers computing PSNR reuse the frames
        already on the device.

    Returns ({absolute frame_idx: decoded}, {absolute frame_idx: bits}).
    """
    decoded = dict(i_frames)
    pending: list = []
    for level, level_frames in enumerate(table.frames_by_level()):
        work = [(g0, f) for f in level_frames for g0 in gop_starts]
        step = len(work) if max_batch is None else max_batch
        for c0 in range(0, len(work), step):
            chunk = work[c0 : c0 + step]
            refs = [table.refs[f] for _, f in chunk]
            ref1 = torch.cat([decoded[g0 + a] for (g0, _), (a, _) in zip(chunk, refs)])
            ref2 = torch.cat([decoded[g0 + b] for (g0, _), (_, b) in zip(chunk, refs)])
            xcur = torch.cat([frames[g0 + f] for g0, f in chunk])
            with obs.span("inter", level=level, batch=len(chunk)):
                x_hat, level_sizes = inter_fn_batched(
                    ref1, ref2, xcur, tuple(f for _, f in chunk), tuple(refs),
                )
            x_hat = torch.clamp(x_hat, 0.0, 1.0)
            for i, (g0, f) in enumerate(chunk):
                decoded[g0 + f] = x_hat[i : i + 1]
                if sources is not None:
                    sources[g0 + f] = xcur[i : i + 1]
            pending.append((chunk, level_sizes))
    # One host fetch for the whole window: a sync between chunks would stall
    # the device; the decoded chain stays on the device throughout.
    return decoded, _fetch_sizes(pending, lambda item: item[0] + item[1])


def code_gop_batched(
    frames,
    i_frames: dict,
    table: GopTable,
    inter_fn_batched: Callable,
    max_batch: int | None = None,
    sources: dict | None = None,
):
    """Code one GOP with level-batched B-frame forwards.

    Args:
      frames: indexable of (1, H, W, 3) source frames, indexed 0..gop.
      i_frames: {0: decoded I, gop: decoded I} anchor reconstructions.
      inter_fn_batched(ref1 (B,H,W,3), ref2, xcur, frame_indices, ref_pairs)
        -> (x_hat (B,H,W,3), sizes (B,)).
      max_batch: cap per-forward batch.

    Returns ({frame_idx: decoded (1,H,W,3)}, {frame_idx: bits}).
    """
    return code_gops_batched(
        frames, i_frames, table, inter_fn_batched, [0], max_batch, sources
    )
