"""The work a phase needs, counted on the plain reference at the cell's
shapes, and the chip's peaks.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over the
reference's pieces on the ``meta`` device: the encoder's (every model
part the encoder runs) and the decoder's (what it runs from the stream and
the references). The same count holds whatever implements the work. Warp
and deform calls are recorded with their shapes from the same pass, and
their bytes and operations are worked out here: each input and output byte
once, float32.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12       # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

#: float32 operations of one warp output element: coordinates, corner
#: weights and the 4-tap blend.
WARP_OPS_PER_ELEMENT = 20
DEFORM_TAPS = 9


def warp_cost(img_shape, flow_shape) -> tuple[float, float]:
    """(bytes, operations) of one warp: image, flow and output once."""
    B, H, W, C = img_shape
    n_out = flow_shape[0] * flow_shape[1] * flow_shape[2] * C
    n_flow = flow_shape[0] * flow_shape[1] * flow_shape[2] * 2
    return 4.0 * (B * H * W * C + n_flow + n_out), float(WARP_OPS_PER_ELEMENT * n_out)


def deform_ops(B, H, W, G, Cg, Og, T=DEFORM_TAPS) -> int:
    """float32 operations of one modulated deform conv: per (pixel, group,
    tap) ~18 for the sample point and corner weights, 8 per channel (4-corner
    blend, mask), 2 per (channel, output), 1 per output; then the bias."""
    return B * H * W * G * (T * (18 + 8 * Cg + 2 * Cg * Og + Og) + Og)


def deform_cost(x_shape, weight_shape, groups: int) -> tuple[float, float]:
    """(bytes, operations) of one deform conv: x, offsets, masks, output,
    weight and bias once."""
    B, H, W, C = x_shape
    C_out = weight_shape[0]
    G, T = groups, DEFORM_TAPS
    n_bytes = 4.0 * (B * H * W * C + B * H * W * G * T * 3 + B * H * W * C_out
                     + weight_shape[0] * weight_shape[1] * T + C_out)
    return n_bytes, float(deform_ops(B, H, W, G, C // G, C_out // G))


def least_seconds(n_bytes: float, ops: float) -> float:
    return max(n_bytes / PEAK_HBM_BYTES, ops / PEAK_F32_FLOPS)


def count(pieces: dict) -> dict:
    """{phase: {"flops", "warp_s", "deform_s", "warp_calls", "deform_calls"}}
    for one sequence: ``pieces[phase]`` is a list of (callable on the meta
    device, times it runs per sequence). ``*_s`` is the least time of the
    phase's warp (deform) calls at the chip's peaks."""
    from reference import deform as ref_deform
    from reference import warp as ref_warp

    out = {}
    for phase, parts in pieces.items():
        flops = warp_s = deform_s = 0.0
        n_warp = n_deform = 0
        for fn, times in parts:
            warps, deforms = [], []
            with ref_warp.recording(warps), ref_deform.recording(deforms), \
                    FlopCounterMode(display=False) as fc:
                fn()
            flops += times * fc.get_total_flops()
            warp_s += times * sum(least_seconds(*warp_cost(*c)) for c in warps)
            deform_s += times * sum(least_seconds(*deform_cost(*c)) for c in deforms)
            n_warp += times * len(warps)
            n_deform += times * len(deforms)
        out[phase] = {"flops": flops, "warp_s": warp_s, "deform_s": deform_s,
                      "warp_calls": n_warp, "deform_calls": n_deform}
    return out
