#!/usr/bin/env python3
"""Smoke run of the tpuvc_torch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

It builds the port's kernels from the sources in the checkout, holds each
against its plain PyTorch version at the shapes the paths give it, and
drives the paths with seeded weights: LHBDC(N=128) codes a GOP-16, 1-GOP
window of 1088x1920 B-frames at batch 4 to real rANS streams, FlowGuidedB
(v4, full width) and DeformB (v3, full width) code the same window at batch
2 and Flex-Rate (v2, N=128) at batch 4, the DMC P-frame codec (feat 48,
N 64) codes a chain of 1088x1920 P-frames, the encode_v / decode_v and
encode_p / decode_p CLIs code whole synthetic sequences (ELIC intra + B-
or P-frames) to a file and back, the RD-eval CLI evaluates a sequence,
FlowGuidedB codes at every down ratio, bench_torch.py runs bench.py's
measurement, and the train CLI trains every family at batch 8 on 256x256
crops, reference checkpoints imported at full width code B-frames, the
still-image eval runs at the Kodak size, the mesh paths run in two
torchrun ranks sharing the card over gloo (and NCCL in a one-rank group),
and the forwards of LHBDC, FlowGuidedB and DeformB run with the frame's rows
split over four ranks;
each decode must reproduce its encoder's reconstructions bit for bit. Each
phase runs under its own time limit and prints JSON lines:

  device             card name, power limit, software versions
  build              warp, deform and epilogue kernels (nvcc, in parallel)
                     and rANS library (g++) build times
  warp_check         kernel vs warp_plain per shape, whole frames and rows
                     [y0, y0 + rows) of a reference (also held to those
                     rows of a whole-frame launch): max abs error (<= 1e-5)
                     and bit for bit,
                     kernel / plain / F.grid_sample times, byte bound
  warp_and_blend     ops.warp.warp_and_blend at (4,1088,1920,3) lhbdc: two
                     warp kernel launches, bit for bit the blend of two
                     warp_plain calls; kernel-path and plain times
  pmf_native         the native pmf -> quantized CDF (coder/csrc/rans.cpp)
                     equal to the numpy quantizer on 50 random pmfs
  deform_check       kernel vs deform_plain at the v4 and v3 paths' three
                     shapes each (16 and 8 groups; batch 2: three offset
                     spreads; batch 1: smooth): max
                     abs error (<= 2e-5), kernel / plain times, byte and
                     operation bounds; at the largest shape and spread, two
                     launches must give the same bits; then rows
                     [y0, y0 + rows) of a whole map (DEFORM_ROW_SHAPES),
                     each bit for bit those rows of a whole-frame launch
  epilogue_check     the conv epilogue kernel vs epilogue_plain at the
                     paths' shapes (EPILOGUE_SHAPES), bit for bit; kernel,
                     plain-ops and two-op rewrite (epilogue_simple) times,
                     byte bound
  train_kernel_check both kernels at the training shapes (batch 8, 256x256
                     crops): the forward against the plain version, the
                     kernel path's gradients (kernel forward, autograd of
                     the plain formulation backward) against the plain
                     version's own, two backward passes bit-identical under
                     the train CLI's deterministic algorithms; forward,
                     forward + backward (under the CLI's determinism and,
                     for comparison, without it; F.grid_sample's for the
                     warp) times and the backward's bound
  reference_check    small LHBDC forward on the card vs the same on the CPU
  reference_check_v4 small full-width FlowGuidedB forward, card vs CPU
  reference_check_v3 the same for DeformB, reference_check_flexrate for
                     Flex-Rate, reference_check_dmc for DMC (two chained
                     P-frames at down ratios 1.0 and 1.5)
  reference_check_train  one LHBDC(N=128) 'ste' training step at 128x128,
                     card vs CPU from the same parameters: the loss and each
                     tensor's gradient error relative to its max
  main_path          LHBDC: B-frames/s, bpp, PSNR, decode_bit_exact, warp
                     launches, peak device memory
  main_path_v4       FlowGuidedB: the same, with deform launches and the
                     flow and offset spread it measured
  main_path_v3       DeformB: the same (deform launches, offset spread)
  main_path_flexrate Flex-Rate: the same (warp launches, the predicted
                     flow's and coded refinement's spread)
  main_path_dmc      DMC at batch 1 from a source-frame DPB: 8 chained
                     P-frames at down ratio 1.0, then 4 at 1.5, encoded
                     (encode_async) and decoded (decode_sequence): P-frames/s,
                     bpp, PSNR, decode_bit_exact, warp launches, the spread
                     of SPyNet's flow and of the decoded MV, peak memory
  sequence_cli       the port's CLIs as a user runs them: encode_v codes
                     synthetic 1088x1920 frames (ELIC intra anchors and
                     B-frames) to one file, decode_v decodes it in another
                     process; one row per run (LHBDC level-batched 17
                     frames, FlowGuidedB sequential 9 frames at down ratio
                     1 and with --adaptive, its flow and offset heads seeded
                     in both processes): frames/s, intra ms per frame, bpp,
                     PSNR, decode_bit_exact, launches, peak device memory,
                     the down ratios --adaptive chose
  sequence_cli_v3_flexrate  the same for DeformB and Flex-Rate, level-batched
                     9 frames each at their windows' batch caps
  sequence_cli_dmc   encode_p --adaptive on 5 synthetic 1088x1920 frames
                     (ELIC I-frame, 4 DMC P-frames), decode_p in a fresh
                     process: frames/s, intra ms per frame, bpp, the down
                     ratios chosen, decode_bit_exact by sha256, peak memory
  decode_under_memory_pressure  the DeformB and DMC streams of the two
                     phases above decoded again in a fresh process while a
                     ballast process holds all of the card but the
                     decoder's peak + the conv-workspace budget + 2 GiB:
                     per-frame sha256 equal to the encoder's
  eval_cli           the RD-eval CLI (tpuvc_torch.cli.test) on 17 frames:
                     FlowGuidedB sequential with the down-ratio search and
                     MS-SSIM in float32, LHBDC level-batched at batch cap 8
                     in bfloat16; frames/s, peak memory, per-level PSNR and
                     bpp, down ratios chosen, launches
  eval_cli_v3_flexrate  the same for DeformB (batch cap 2) and Flex-Rate
                     (batch cap 4), level-batched, bfloat16
  eval_cli_dmc       the same for DMC: low-delay, the fractional ratio
                     search, float32, with the ratios chosen read back from
                     its per-frame diagnostics CSV
  train_cli          the train CLI's main for every family in turn, twice
                     each, in one subprocess, at full width, batch 8,
                     256x256 synthetic crops, 2 steps, stage 2 of the
                     recursive families from the second (FlowGuidedB with
                     one BD-rate validation, its best.msgpack reported, DMC
                     with two P-frames): the first run's steps/s after the
                     first, frames trained per second, the last loss, rate
                     and distortion, peak memory, launches; latest.msgpack
                     loaded strictly, the weights and quantiles moved
  train_determinism  each family's two train_cli runs (one seed, one batch
                     stream, the CLI's deterministic_training): the
                     parameters' sha256 equal
  trained_checkpoint_codes  train_cli's LHBDC checkpoint codes a 1088x1920
                     B-frame through encode_b --weights; decode_b in a
                     fresh process must reproduce it bit for bit
  imported_checkpoint_codes  reference .pth checkpoints of every importer
                     family (LHBDC N=128, Flex-Rate N=128, ELIC, DeformB,
                     FlowGuidedB at full width, tests/torch_reference_sd.py)
                     converted by the import_torch CLI and loaded strictly;
                     the imported LHBDC and FlowGuidedB each code a 1088x1920
                     B-frame through encode_b --weights, decode_b in a fresh
                     process must reproduce it bit for bit
  image_eval_cli     the still-image eval CLI (test_image) on three
                     synthetic 768x512 images at levels 0 (the imported
                     ELIC) and 1 (seeded): images/s, per-level PSNR and bpp,
                     peak memory; the RD-eval CLI's write_plots exits naming
                     matplotlib where it is missing (draws where it is not)
  mesh_sequence_cli  encode_v --mesh 2 in two gloo ranks sharing the card
                     (python -m torch.distributed.run), decode_v in a fresh
                     2-rank launch: LHBDC and FlowGuidedB 9 frames of
                     1088x1920, level-batched at cap 2, bf16: the header's
                     mesh, per-frame sha256 of every rank's decode against
                     the encoder's, the largest difference from a mesh-1
                     run at the ranks' batch shapes (<= 1e-4), frames/s,
                     each rank's peak memory and launches; then
                     level_batch_shape_dependence (reported): one level
                     batch coded at batch 2 and as two batches of 1
  mesh_train_cli     the train CLI for LHBDC(N=128) in two gloo ranks on the
                     card, global batch 8, 2 steps: the ranks' parameters
                     bit-identical by sha256, the step-0 averaged gradients
                     against one process's under reference_check_train's
                     bars, steps/s
  nccl_world1        a one-rank NCCL group on cuda:0: make_mesh and the
                     collectives of CUDA tensors give the expected values
  mesh_spatial_forward  the forwards of all six families (LHBDC and
                     Flex-Rate N=128, the others at full width; B-frames,
                     DMC's P-frames 8 and 16, an ELIC frame) of 1088x1920
                     frames with their rows split over four gloo ranks
                     sharing the card, every process capped at 10 GiB
                     (tpuvc_torch.parallel.spatial: explicit row fetches,
                     the warp and deform kernels at each rank's first row)
                     against the same forwards unsharded in this process:
                     forward ms, peak memory, warp and deform launches and
                     their y0, bytes fetched, warp samples and deform taps
                     in other ranks' rows, x_hat's difference, flipped
                     latents, the bits
  adaptive_ratios    FlowGuidedB coded at down ratios 2, 4, 8, 16, each
                     stream decoded bit for bit
  bench_torch        bench_torch.py in a subprocess: its last record must
                     be bit-exact, with two timed windows and eval_fps;
                     its launches are those of its timed coding windows
                     and, apart, of its timed eval passes
  path_shapes_check  every kernel shape the paths launched in this process
                     that the checks above did not cover, held against the
                     plain version (the epilogue's bit for bit) (bench_torch.py's shapes are a subset of
                     eval_cli's and main_path's)

then one ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failure raises
and the script exits non-zero; so does a machine without a CUDA card, and a
directory that holds this script without the package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
WARP_OPS_PER_ELEMENT = 20  # coordinates, weights and the 4-tap blend

# Shapes of the main path's warps: SPyNet's finest and coarsest pyramid
# levels (two flows batched at B=4), motion compensation at B=4, the DMC
# context-warp width at an unaligned size and at its path's, and one
# zero-padded warp.
# Every other shape a path launches is checked after the paths ran
# (path_shapes_check).
WARP_SHAPES = [
    ("lhbdc", (8, 1088, 1920, 3)),
    ("lhbdc", (4, 1088, 1920, 3)),
    ("lhbdc", (8, 34, 60, 3)),
    ("exact", (1, 1081, 1917, 48)),
    ("flexrate", (4, 1088, 1920, 3)),
    # FlowGuidedB's feature warps at B=2: the /2, /4, /8 pyramid levels.
    ("exact", (2, 544, 960, 64)),
    ("exact", (2, 272, 480, 96)),
    ("exact", (2, 136, 240, 128)),
    # sequence_cli's LHBDC level 1 (two B-frames): motion compensation at
    # B=2, SPyNet at B=4 down to its coarsest level.
    ("lhbdc", (2, 1088, 1920, 3)),
    ("lhbdc", (4, 34, 60, 3)),
    # sequence_cli's sequential FlowGuidedB: the feature warps at B=1.
    ("exact", (1, 544, 960, 64)),
    ("exact", (1, 272, 480, 96)),
    ("exact", (1, 136, 240, 128)),
    # The down-ratio search's flow-only predictions: both references warped
    # at full resolution, B=1.
    ("exact", (1, 1088, 1920, 3)),
    # The eval's LHBDC likelihood forward at max_batch 8: SPyNet's four
    # flows batched at B=32, its finest level.
    ("lhbdc", (32, 1088, 1920, 3)),
    # Flex-Rate's four full-resolution warps a B-frame: B=1 (a level of one
    # frame), B=2 (level 0 of a 2-GOP window); B=4 is the row above.
    ("flexrate", (1, 1088, 1920, 3)),
    ("flexrate", (2, 1088, 1920, 3)),
    # DMC's motion compensation: the 48-channel feature warp (the frame's
    # own is the exact (1, 1088, 1920, 3) row above).
    ("exact", (1, 1088, 1920, 48)),
]

# Warps of output rows [y0, y0 + rows) of a whole reference (the kernel's
# row offset), at mesh_spatial_forward's shapes: rank 1's rows of SPyNet's
# finest level (its four flows batched), rank 3's rows of a compensation
# warp, and rank 3's ragged rows of SPyNet's coarsest level. (compat, whole
# shape, y0, rows); the other ranks' and levels' go to path_shapes_check.
WARP_ROW_SHAPES = [
    ("lhbdc", (4, 1088, 1920, 3), 272, 272),
    ("lhbdc", (1, 1088, 1920, 3), 816, 272),
    ("lhbdc", (4, 34, 60, 3), 27, 7),
    # rank 1's rows of a Flex-Rate warp (the zero ring), rank 3's of DMC's
    # 48-channel feature warp
    ("flexrate", (1, 1088, 1920, 3), 272, 272),
    ("exact", (1, 1088, 1920, 48), 816, 272),
]

# The coded window of the main_path phases: bench.py's frame size and GOP,
# one GOP (bench.py's two until the smoke's time limit asked for the cut;
# bench_torch keeps them).
FRAME, GOP, WINDOW_GOPS = (1088, 1920), 16, 1

# The deform convs at 1088x1920: (level, x shape, groups, output channels,
# tanh bound of the widest offsets in px, offset spreads to check), 3x3
# taps. FlowGuidedB (v4) fuses both references in one 16-group conv a
# level; DeformB (v3) aligns each reference with its own 8-group conv over
# 32/64/96 channels (4/8/12 a group: the kernel's <V=4, MAXO=8> instance).
# B=2 is main_path_v4's and main_path_v3's batch, with all three spreads;
# B=1 is a sequential run's (or a level of one frame), smooth offsets only.
# v3's offsets are not tanh-bounded: its widest spread reuses v4's bounds.
DEFORM_SPREADS = ("zero", "smooth", "tanh")
DEFORM_SHAPES = [
    ("L1", (2, 544, 960, 128), 16, 64, 40.0, DEFORM_SPREADS),
    ("L2", (2, 272, 480, 192), 16, 96, 20.0, DEFORM_SPREADS),
    ("L3", (2, 136, 240, 256), 16, 128, 10.0, DEFORM_SPREADS),
    ("L1", (1, 544, 960, 128), 16, 64, 40.0, ("smooth",)),
    ("L2", (1, 272, 480, 192), 16, 96, 20.0, ("smooth",)),
    ("L3", (1, 136, 240, 256), 16, 128, 10.0, ("smooth",)),
    ("v3 L1", (2, 544, 960, 32), 8, 32, 40.0, DEFORM_SPREADS),
    ("v3 L2", (2, 272, 480, 64), 8, 64, 20.0, DEFORM_SPREADS),
    ("v3 L3", (2, 136, 240, 96), 8, 96, 10.0, DEFORM_SPREADS),
    ("v3 L1", (1, 544, 960, 32), 8, 32, 40.0, ("smooth",)),
    ("v3 L2", (1, 272, 480, 64), 8, 64, 20.0, ("smooth",)),
    ("v3 L3", (1, 136, 240, 96), 8, 96, 10.0, ("smooth",)),
]
DEFORM_TAPS = 9

# Deform convs of output rows [y0, y0 + rows) of a whole map (the kernel's
# row offset), smooth offsets: rank 1's rows of v4's largest level, rank 3's
# of v3's (they end at the frame's last row), and one row of v4's smallest
# level. (level, x shape, groups, output channels, y0, rows); the spatial
# path's own (B=1) rows go to path_shapes_check.
DEFORM_ROW_SHAPES = [
    ("L1", (2, 544, 960, 128), 16, 64, 136, 136),
    ("v3 L1", (2, 544, 960, 32), 8, 32, 408, 136),
    ("L3", (2, 136, 240, 256), 16, 128, 67, 1),
]


# The conv epilogue's shapes on the paths (NHWC, the conv output's dtype,
# activation, slope, residual, bias): SPyNet's full-resolution convs at
# batch 8 (coding's two flows of four B-frames; the last with SPyNet's
# upsampled flow as residual), MaskUNet's first conv, a
# ResidualBottleneckBlock's last conv with its residual, a hyperprior's leaky
# ReLU, a transposed conv's cast (no bias, no activation) and a float32
# conv's bias and ReLU. The first is the kernel's headline. Every other
# shape a path launched goes to path_shapes_check.
EPILOGUE_SHAPES = [
    ("spynet_conv1", (8, 1088, 1920, 64), "bfloat16", "relu", 0.01, False, True),
    ("spynet_conv0", (8, 1088, 1920, 32), "bfloat16", "relu", 0.01, False, True),
    ("spynet_conv3", (8, 1088, 1920, 16), "bfloat16", "relu", 0.01, False, True),
    ("spynet_conv4_residual", (8, 1088, 1920, 2), "bfloat16", None, 0.01, True, True),
    ("maskunet_conv0", (4, 1088, 1920, 32), "bfloat16", "relu", 0.01, False, True),
    ("bottleneck_conv2_residual", (4, 272, 480, 128), "bfloat16", None, 0.01, True, True),
    ("hyperprior_leaky", (4, 68, 120, 128), "bfloat16", "leaky_relu", 0.01, False, True),
    ("deconv_cast", (4, 544, 960, 128), "bfloat16", None, 0.01, False, False),
    ("float32_bias_relu", (4, 544, 960, 64), "float32", "relu", 0.01, False, True),
]


def deform_ops(B, H, W, G, Cg, Og, T=DEFORM_TAPS) -> int:
    """float32 operations of one deform conv: per (pixel, group, tap) ~18
    for the sample point and corner weights, 8 per channel (4-corner blend,
    mask), 2 per (channel, output), 1 per output; then the bias."""
    return B * H * W * G * (T * (18 + 8 * Cg + 2 * Cg * Og + Og) + Og)


def emit(payload) -> None:
    print(json.dumps(payload), flush=True)


@contextlib.contextmanager
def phase(name: str, limit_s: int):
    """Run a phase under a SIGALRM time limit; the timeout raises. Prints
    the phase's wall seconds when it ends."""

    def on_alarm(signum, frame):
        raise TimeoutError(f"phase {name} exceeded {limit_s} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(limit_s)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        emit({"phase_done": name, "s": time.perf_counter() - t0})


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def warp_check(torch) -> list[dict]:
    """The kernel against warp_plain at WARP_SHAPES (whole frames) and
    WARP_ROW_SHAPES (rows [y0, y0 + rows), also held to those rows of a
    whole-frame launch): bit for bit; kernel, plain and F.grid_sample times
    and the byte bound. The bound counts the reference rows the samples
    reach (per batch, the lowest to the highest), the flow and the output."""
    import torch.nn.functional as F

    from tpuvc_torch.ops import warp as W

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cases = [(c, s, 0, s[1]) for c, s in WARP_SHAPES] + WARP_ROW_SHAPES
    for compat, shape, y0, n_rows in cases:
        B, H, Wd, C = shape
        img = torch.rand(shape, generator=gen, device="cuda")
        flow_full = 4.0 * torch.randn((B, H, Wd, 2), generator=gen, device="cuda")
        flow = flow_full[:, y0:y0 + n_rows].contiguous()
        out_k = W.warp(img, flow, compat, y0)
        out_p = W.warp_plain(img, flow, compat, y0)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        bit_exact = bool(torch.equal(out_k, out_p))
        if n_rows != H:
            bit_exact = bit_exact and bool(torch.equal(
                out_k, W.warp(img, flow_full, compat)[:, y0:y0 + n_rows]))
        del out_k, out_p, flow_full
        if not (err <= 1e-5 and bit_exact):
            raise AssertionError(f"warp {compat} {shape} rows {y0}+{n_rows}: max abs err {err}, "
                                 f"bit_exact {bit_exact}")

        # One F.grid_sample call for the same sampling, as a yardstick only.
        sx, sy, zero = W._scales(compat, H, Wd)
        shift = -0.5 if zero else 0.0
        xs = torch.arange(Wd, device="cuda", dtype=torch.float32)
        ys = torch.arange(y0, y0 + n_rows, device="cuda", dtype=torch.float32)
        gx = (xs + (flow[..., 0] + shift) * sx) * (2.0 / (Wd - 1)) - 1.0
        gy = (ys[:, None] + (flow[..., 1] + shift) * sy) * (2.0 / (H - 1)) - 1.0
        grid = torch.stack([gx, gy], dim=-1)
        img_nchw = img.permute(0, 3, 1, 2).contiguous()
        pad = "zeros" if zero else "border"
        # the reference rows the samples reach, per batch
        reach = torch.clamp(ys[:, None] + (flow[..., 1] + shift) * sy, 0.0, H - 1.0).floor()
        lo = reach.amin(dim=(1, 2))
        hi = torch.clamp(reach.amax(dim=(1, 2)) + 1, max=H - 1)
        img_rows = int((hi - lo + 1).sum())

        iters = 20 if B * n_rows * Wd > 1e6 else 200
        ms = time_ms(torch, lambda: W.warp(img, flow, compat, y0), iters)
        plain_ms = time_ms(torch, lambda: W.warp_plain(img, flow, compat, y0), 3, 1)
        library_ms = time_ms(
            torch,
            lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                  padding_mode=pad, align_corners=True),
            iters,
        )
        n_out = B * n_rows * Wd * C
        bytes_moved = 4 * (img_rows * Wd * C + n_out + 2 * B * n_rows * Wd)
        bound_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
        bound_ops = 1e3 * WARP_OPS_PER_ELEMENT * n_out / F32_OPS_PER_S
        row = {
            "phase": "warp_check", "compat": compat, "shape": list(shape),
            "y0": y0, "rows": n_rows,
            "max_abs_err": err, "bit_exact": bit_exact, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        }
        emit(row)
        rows.append(row)
        del img, flow, grid, img_nchw
        torch.cuda.empty_cache()
    return rows


def smooth_offsets(torch, gen, B, H, W, n):
    """Offsets that vary smoothly over +-5 px: a coarse random grid upsampled."""
    import torch.nn.functional as F

    coarse = torch.rand((B, n, H // 16, W // 16), generator=gen, device="cuda")
    up = 10.0 * F.interpolate(coarse, size=(H, W), mode="bilinear") - 5.0
    return up.permute(0, 2, 3, 1).contiguous()


def deform_inputs(torch, gen, B, H, W, C, C_out, G, T=DEFORM_TAPS):
    """Seeded x, masks, weight (C_out, C/G, 3, 3) and bias for one deform conv."""
    Cg = C // G
    x = torch.randn((B, H, W, C), generator=gen, device="cuda")
    masks = torch.rand((B, H, W, G * T), generator=gen, device="cuda")
    weight = torch.randn((C_out, Cg, 3, 3), generator=gen, device="cuda") / (T * Cg) ** 0.5
    bias = 0.1 * torch.randn((C_out,), generator=gen, device="cuda")
    return x, masks, weight, bias


def deform_check(torch) -> list[dict]:
    """The deform kernel against deform_plain at the v4 and v3 paths'
    shapes, with offsets at up to three spreads: 0 (integer taps), smooth
    +-5 px, and the level's tanh bound (40/20/10 px: many samples leave the
    frame); then DEFORM_ROW_SHAPES (deform_row_check)."""
    from tpuvc_torch.ops import deform as D

    gen = torch.Generator(device="cuda").manual_seed(1)
    T = DEFORM_TAPS
    rows = []
    for level, (B, H, W, C), G, C_out, bound, kinds in DEFORM_SHAPES:
        Cg, Og = C // G, C_out // G
        x, masks, weight, bias = deform_inputs(torch, gen, B, H, W, C, C_out, G)
        n_off = G * T * 2
        make = {
            "zero": lambda: ("zero", torch.zeros((B, H, W, n_off), device="cuda")),
            "smooth": lambda: ("smooth_5px", smooth_offsets(torch, gen, B, H, W, n_off)),
            "tanh": lambda: (f"tanh_{bound:g}px", bound * torch.tanh(
                2.0 * torch.randn((B, H, W, n_off), generator=gen, device="cuda"))),
        }
        spreads = dict(make[k]() for k in kinds)
        n_bytes = 4 * (x.numel() + B * H * W * n_off + masks.numel()
                       + B * H * W * C_out + weight.numel() + bias.numel())
        bound_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
        bound_ops = 1e3 * deform_ops(B, H, W, G, Cg, Og) / F32_OPS_PER_S
        for spread, off in spreads.items():
            args = (x, off, masks, weight, bias, G, 3)
            out_k = D.deform_kernel(*args)
            out_p = D.deform_plain(*args)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            scale = float(out_p.abs().max())
            del out_k, out_p
            row = {
                "phase": "deform_check", "level": level, "spread": spread,
                "x_shape": [B, H, W, C], "groups": G, "out_channels": C_out, "y0": 0, "rows": H,
                "max_abs_err": err, "max_abs_out": scale,
                "ms": time_ms(torch, lambda: D.deform_kernel(*args), 10),
                "plain_ms": time_ms(torch, lambda: D.deform_plain(*args), 2, 1),
                "library_ms": None,
                "bound_ms": max(bound_bytes, bound_ops),
                "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
                "bytes_bound_ms": bound_bytes, "ops_bound_ms": bound_ops,
            }
            if spread.startswith("tanh") and level.endswith("L1") and B == 2:
                # Encoder and decoder run the same launch: full size, widest
                # spread, the same bits twice.
                first = D.deform_kernel(*args)
                row["repeat_bit_exact"] = bool(torch.equal(D.deform_kernel(*args), first))
                del first
            emit(row)
            rows.append(row)
            if not err <= 2e-5:
                raise AssertionError(f"deform {level} {spread}: max abs err {err} > 2e-5")
            if row.get("repeat_bit_exact") is False:
                raise AssertionError(f"deform {level} {spread}: two launches differ")
        del x, masks, weight, bias, spreads
        torch.cuda.empty_cache()
    return rows + deform_row_check(torch, gen)


def deform_row_check(torch, gen) -> list[dict]:
    """The kernel's row offset at DEFORM_ROW_SHAPES: a launch for rows
    [y0, y0 + rows) from offsets and masks of those rows must equal those
    rows of a whole-frame launch bit for bit, and deform_plain with the same
    y0 within 2e-5. The byte bound counts the rows' offsets, masks and
    output and the rows of x their taps reach (per batch, the lowest to the
    highest)."""
    from tpuvc_torch.ops import deform as D

    T = DEFORM_TAPS
    rows = []
    for level, (B, H, W, C), G, C_out, y0, n in DEFORM_ROW_SHAPES:
        Cg, Og = C // G, C_out // G
        x, masks_full, weight, bias = deform_inputs(torch, gen, B, H, W, C, C_out, G)
        off_full = smooth_offsets(torch, gen, B, H, W, G * T * 2)
        whole = D.deform_kernel(x, off_full, masks_full, weight, bias, G, 3)[:, y0:y0 + n].clone()
        off, masks = (t[:, y0:y0 + n].contiguous() for t in (off_full, masks_full))
        del off_full, masks_full
        args = (x, off, masks, weight, bias, G, 3, y0)
        out_k = D.deform_kernel(*args)
        out_p = D.deform_plain(*args)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        equal = bool(torch.equal(out_k, whole))
        del out_k, out_p, whole
        # the rows of x the taps reach, per batch: floor of the row positions
        # and the row below, clipped to the frame
        base = torch.arange(T, device="cuda") // 3 - 1
        ys = torch.arange(y0, y0 + n, device="cuda")[None, :, None, None, None]
        reach = torch.floor(ys + base + off[..., 0::2].reshape(B, n, W, G, T))
        lo = torch.clamp(reach.amin(dim=(1, 2, 3, 4)), 0, H - 1)
        hi = torch.clamp(reach.amax(dim=(1, 2, 3, 4)) + 1, 0, H - 1)
        x_rows = int((hi - lo + 1).sum())
        n_bytes = 4 * (x_rows * W * C + off.numel() + masks.numel() + B * n * W * C_out
                       + weight.numel() + bias.numel())
        bound_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
        bound_ops = 1e3 * deform_ops(B, n, W, G, Cg, Og) / F32_OPS_PER_S
        row = {
            "phase": "deform_check", "level": level, "spread": "smooth_5px",
            "x_shape": [B, H, W, C], "groups": G, "out_channels": C_out, "y0": y0, "rows": n,
            "max_abs_err": err, "equals_whole_frame_rows": equal,
            "ms": time_ms(torch, lambda: D.deform_kernel(*args), 20),
            "plain_ms": time_ms(torch, lambda: D.deform_plain(*args), 2, 1),
            "library_ms": None,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "bytes_bound_ms": bound_bytes, "ops_bound_ms": bound_ops, "x_rows_reached": x_rows,
        }
        emit(row)
        rows.append(row)
        if not (err <= 2e-5 and equal):
            raise AssertionError(f"deform {level} rows {y0}+{n}: max abs err {err}, "
                                 f"equal to the whole frame's rows {equal}")
        del x, off, masks, weight, bias, args
        torch.cuda.empty_cache()
    return rows


#: The families whose seeded models start heads at zero (seed_zero_heads).
SEEDED_FAMILIES = ("flowguided_b", "deform_b", "flexrate")


def _family(model) -> str:
    from tpuvc_torch.models.deform_b import DeformB
    from tpuvc_torch.models.dmc import PFrameDMC
    from tpuvc_torch.models.flexrate import BidirFlowRef
    from tpuvc_torch.models.flowguided_b import FlowGuidedB

    for cls, name in ((FlowGuidedB, "flowguided_b"), (DeformB, "deform_b"),
                      (BidirFlowRef, "flexrate"), (PFrameDMC, "dmc")):
        if isinstance(model, cls):
            return name
    raise TypeError(f"no zero-initialised heads known for {type(model).__name__}")


def zero_heads(model) -> list:
    """(final conv, scale of its seeded draw) of each head the family starts
    at zero: FlowGuidedB's flow head and offset heads, DeformB's offset
    heads, Flex-Rate's flow-refinement synthesis."""
    family = _family(model)
    if family == "flexrate":
        return [(model.flow_compressor.g_s_layers[-1].Conv_0, 0.1)]
    offsets = [(getattr(model.offset_compressor, g).Conv_1,
                0.05 if family == "flowguided_b" else 1.0)
               for g in ("g_o1", "g_o2", "g_o3")]
    if family == "flowguided_b":
        return [(model.flow_estimator.SubpelConv_3.Conv_0, 1.0)] + offsets
    return offsets


def seed_zero_heads(model, generator):
    """Give a family's zero-initialised heads seeded weights.

    With seeded weights FlowGuidedB's flows would be 0, every offset of
    FlowGuidedB and DeformB an integer tap and every mask 0.5, and
    Flex-Rate's coded flow refinement exactly 0: the deform kernel's blend,
    the warp's fractional samples and the decoder's agreement on them would
    go untested. Their final convs get flax's lecun-normal draw, scaled
    (``zero_heads``), which gives flows and offsets a fractional spread of
    a few pixels at full width."""
    from tpuvc_torch.models.layers import lecun_normal_

    for conv, scale in zero_heads(model):
        lecun_normal_(conv.weight, generator)
        conv.weight.data.mul_(scale)
    return model


def spread_points(model) -> dict:
    """{key: (module, pick(args, out))}: where each family's flows and
    offsets can be read. FlowGuidedB: FlowNET's flow and the offsets of the
    three deform convs (L1..L3); DeformB: the offsets of each level's first
    deform conv; Flex-Rate: the predicted flow and the coded refinement;
    DMC: SPyNet's flow and the decoded MV (``mv_out``, lecun-normal when
    seeded, so no head needs seeding)."""
    family = _family(model)
    if family == "dmc":
        return {"flow": (model.optic_flow, lambda a, o: o),
                "mv": (model.mv_out, lambda a, o: o)}
    if family == "flexrate":
        return {"flow": (model.flow_predictor, lambda a, o: o),
                "refinement": (model.flow_compressor.g_s_layers[-1], lambda a, o: o)}
    if family == "deform_b":
        convs = {f"L{i}": getattr(model, f"deconv_l{i}_1") for i in (1, 2, 3)}
        return {k: (m, lambda a, o: a[1]) for k, m in convs.items()}
    return {"flow": (model.flow_estimator, lambda a, o: o), **{
        f"L{i}": (getattr(model, f"offset_diversity_l{i}").DeformConv_0, lambda a, o: a[1])
        for i in (1, 2, 3)}}


def spread_hooks(torch, model, spread: dict) -> list:
    """Forward hooks that put the first value at each of the family's
    ``spread_points`` into ``spread``: its std and largest magnitude in px
    and the share of fractional values."""

    def measure(key, pick):
        def hook(mod, args, out):
            if key not in spread:
                v = pick(args, out)
                frac = v - torch.floor(v)
                spread[key] = {
                    "std_px": float(v.std()), "max_abs_px": float(v.abs().max()),
                    "fractional_share": float(((frac > 1e-3) & (frac < 1 - 1e-3)).float().mean()),
                }
        return hook

    return [m.register_forward_hook(measure(k, pick))
            for k, (m, pick) in spread_points(model).items()]


#: The keys of each family's spread_points.
SPREAD_KEYS = {"flowguided_b": {"flow", "L1", "L2", "L3"}, "deform_b": {"L1", "L2", "L3"},
               "flexrate": {"flow", "refinement"}, "dmc": {"flow", "mv"}}


def check_spread(spread: dict, where: str, family: str = "flowguided_b") -> None:
    """Fail unless every spread point of ``family`` was measured and is
    spread over fractional values."""
    if set(spread) != SPREAD_KEYS[family] or not all(
        v["fractional_share"] > 0 and v["std_px"] > 0 for v in spread.values()
    ):
        raise AssertionError(f"{where}: the flow and offsets have no fractional spread: {spread}")


@contextlib.contextmanager
def cli_heads_seeded(spread: dict | None = None):
    """While open, the CLIs' models of SEEDED_FAMILIES (``encode_b.load_model``,
    which encode_v and decode_v call, and the eval CLI's ``build_models``)
    get :func:`seed_zero_heads` with the generator :func:`v4_model` uses, so
    an encoder and a decoder in two processes build the same fractional
    flows and offsets. With ``spread``, the model's :func:`spread_hooks`
    fill it."""
    import torch

    from tpuvc_torch.cli import encode_b
    from tpuvc_torch.cli import test as eval_cli

    load, build = encode_b.load_model, eval_cli.build_models

    def seeded(model):
        seed_zero_heads(model, torch.Generator().manual_seed(1))
        if spread is not None:
            spread_hooks(torch, model, spread)
        return model

    def load_model(args):
        model = load(args)
        return seeded(model) if args.family in SEEDED_FAMILIES else model

    def build_models(cfg, rng_seed=0):
        intra, model = build(cfg, rng_seed)
        return intra, seeded(model) if cfg.model.family in SEEDED_FAMILIES else model

    encode_b.load_model, eval_cli.build_models = load_model, build_models
    try:
        yield
    finally:
        encode_b.load_model, eval_cli.build_models = load, build


def _seeded(torch, model_cls, seed, **kw):
    model = model_cls(generator=torch.Generator().manual_seed(seed), **kw)
    return seed_zero_heads(model, torch.Generator().manual_seed(seed + 1))


def v4_model(torch, N=128, seed=0, **kw):
    """FlowGuidedB at the repo's v4 widths (feature_channels (64, 96, 128),
    N=M=128, 5 levels, groups (6, 6, 12, 24, 80)), seeded weights, seeded
    heads."""
    from tpuvc_torch.models.flowguided_b import FlowGuidedB

    return _seeded(torch, FlowGuidedB, seed, N=N, M=N, **kw)


def v3_model(torch, N=128, seed=0, **kw):
    """DeformB at the repo's v3 widths (feature_channels (32, 64, 96),
    N=M=128, 5 levels, groups (6, 6, 12, 24, 80)), seeded weights, seeded
    offset heads."""
    from tpuvc_torch.models.deform_b import DeformB

    return _seeded(torch, DeformB, seed, N=N, M=N, **kw)


def flexrate_model(torch, N=128, seed=0, **kw):
    """Flex-Rate's BidirFlowRef at full width (N=128, 6 gain levels), seeded
    weights, seeded flow-refinement synthesis."""
    from tpuvc_torch.models.flexrate import BidirFlowRef

    return _seeded(torch, BidirFlowRef, seed, N=N, **kw)


def dmc_model(torch, seed=0, **kw):
    """PFrameDMC at its canonical width (feat 48, N 64, tpuvc's encode_p
    defaults), seeded weights."""
    from tpuvc_torch.models.dmc import PFrameDMC

    return PFrameDMC(generator=torch.Generator().manual_seed(seed), **kw)


def reference_check(torch) -> dict:
    """A small LHBDC forward on the card (warp kernel, cuDNN, float32 with
    TF32 off) against the same model on the CPU (plain warp). Convolutions
    sum in other orders on the two devices: the bars allow that noise,
    about 1e-6 relative per layer, and no flipped quantization bin."""
    from tpuvc_torch.models.lhbdc import LHBDC

    model = LHBDC(N=128, generator=torch.Generator().manual_seed(1)).eval()
    g = torch.Generator().manual_seed(2)
    xb, xc, xa = (torch.rand((1, 128, 128, 3), generator=g) for _ in range(3))
    with torch.no_grad():
        ref = model(xb, xc, xa, "dequantize")
        model.cuda()
        out = model(xb.cuda(), xc.cuda(), xa.cuda(), "dequantize")
    diff = (out["x_hat"].cpu() - ref["x_hat"]).abs()
    x_err = float(diff.max())
    # A flipped quantization bin moves reconstructed pixels by >> 1e-3.
    flipped_px = int((diff > 1e-3).sum())
    bits_rel = abs(float(out["bits"]) - float(ref["bits"])) / float(ref["bits"])
    row = {"phase": "reference_check", "shape": [1, 128, 128, 3], "N": 128,
           "x_hat_max_abs_err": x_err, "x_hat_px_over_1e-3": flipped_px,
           "bits_rel_err": bits_rel}
    emit(row)
    if not (x_err <= 1e-4 and bits_rel <= 1e-5):
        raise AssertionError(f"card vs CPU forward disagrees: {row}")
    return row


def card_vs_cpu(torch, phase_name: str, model_desc: str, model, forward) -> dict:
    """A small full-width forward on the card (the kernels, cuDNN, float32
    with TF32 off) against the same model on the CPU (plain versions), at
    (1, 128, 128, 3). ``forward(model, x1, xc, x2)`` -> the model's output
    dict (x_hat, size)."""
    g = torch.Generator().manual_seed(4)
    x1, xc, x2 = (torch.rand((1, 128, 128, 3), generator=g) for _ in range(3))
    model = model.eval()
    with torch.no_grad():
        ref = forward(model, x1, xc, x2)
        model.cuda()
        out = forward(model, x1.cuda(), xc.cuda(), x2.cuda())
    diff = (out["x_hat"].cpu() - ref["x_hat"]).abs()
    x_err = float(diff.max())
    scale = float(ref["x_hat"].abs().max())
    bits, ref_bits = float(out["size"].sum()), float(ref["size"].sum())
    bits_rel = abs(bits - ref_bits) / ref_bits
    row = {"phase": phase_name, "shape": [1, 128, 128, 3], "model": model_desc,
           "x_hat_max_abs_err": x_err, "x_hat_max_abs": scale, "bits_rel_err": bits_rel}
    emit(row)
    if not (x_err <= 1e-4 * max(1.0, scale) and bits_rel <= 1e-5):
        raise AssertionError(f"card vs CPU forward disagrees: {row}")
    return row


def reference_check_v4(torch) -> dict:
    return card_vs_cpu(
        torch, "reference_check_v4", "FlowGuidedB full width", v4_model(torch, seed=3),
        lambda m, x1, xc, x2: m(x1, x2, xc, 1.0, 0.5, 0.5, 1, "dequantize"))


def reference_check_v3(torch) -> dict:
    return card_vs_cpu(
        torch, "reference_check_v3", "DeformB full width, offset heads seeded",
        v3_model(torch, seed=3), lambda m, x1, xc, x2: m(x1, x2, xc, 1.0, "dequantize"))


def reference_check_flexrate(torch) -> dict:
    return card_vs_cpu(
        torch, "reference_check_flexrate", "Flex-Rate N=128, refinement seeded, n=1 l=0.66",
        flexrate_model(torch, seed=3),
        lambda m, x1, xc, x2: m(x1, xc, x2, 1, 0.66, "dequantize"))


def reference_check_dmc(torch) -> dict:
    """Two chained P-frames from a DPB on the first frame: the second at
    down ratio 1.0, the third at 1.5 (the antialiased resize and SPyNet at
    a padded size)."""

    def forward(m, x1, xc, x2):
        dpb = {"ref_frame": x1, "ref_feature": None, "ref_down_ratio": 1.0}
        outs = []
        for x, ratio in ((xc, 1.0), (x2, 1.5)):
            outs.append(m(x, dpb, ratio, "dequantize"))
            dpb = outs[-1]["dpb"]
        return {"x_hat": torch.cat([o["x_hat"] for o in outs]),
                "size": torch.stack([o["bits"] for o in outs])}

    return card_vs_cpu(torch, "reference_check_dmc", "PFrameDMC feat 48 N 64, ratios 1.0, 1.5",
                       dmc_model(torch, seed=3), forward)


def drive_window(torch, coder, phase_name: str, model: str, B: int, family: str,
                 kernels: list[str], dtype: str = "bfloat16",
                 after_warm=None, extra: dict | None = None) -> dict:
    """The window of ``bench_torch.bench_window`` at full size (FRAME, GOP,
    WINDOW_GOPS), at batch B, encoded then decoded twice: the first window warms
    cuDNN and the allocator, the second is timed. Every launch count is set
    to 0 just before and read just after; each of ``kernels`` must have
    launched, and every decode must equal its encoder's reconstructions.
    ``after_warm`` runs after the warm window's encode; ``extra`` joins the
    printed row."""
    from bench_torch import bench_window
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.ops.precision import policy_from_name

    (h, w), gop, G = FRAME, GOP, WINDOW_GOPS
    code_window, decode_window, slot, n_real = bench_window(
        torch, coder, h, w, gop, G, B, family=family
    )
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        with policy_from_name(dtype):
            t0 = time.perf_counter()
            bits, recons = code_window()
            warm_s = time.perf_counter() - t0
            if after_warm is not None:
                after_warm()
            dec = decode_window(bits)
            bit_exact = all(torch.equal(dec[f], recons[f]) for f in recons)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bits2, recons2 = code_window()
            torch.cuda.synchronize()
            t_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            dec2 = decode_window(bits2)
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t0
            bit_exact = bit_exact and all(
                torch.equal(dec2[f], recons2[f]) for f in recons2
            )
        launches = read_launches()
    finally:
        parallel.shutdown()

    x_hats = torch.cat([recons2[f] for f in sorted(recons2)])
    src = torch.cat([slot[f] for f in sorted(recons2)])
    finite = bool(torch.isfinite(x_hats).all())
    mse = ((x_hats.clamp(0, 1) - src) ** 2).mean(dim=(1, 2, 3))
    psnr = float((10 * torch.log10(1.0 / mse)).mean())
    total_bytes = sum(b.num_bytes for b in bits2.values())
    row = {
        "phase": phase_name, "model": model,
        "frame": [h, w], "gop": gop, "window_gops": G, "batch": B,
        "compute_dtype": dtype, "b_frames_per_window": n_real,
        "encode_fps": n_real / t_enc, "decode_fps": n_real / t_dec,
        "encdec_fps": 2 * n_real / (t_enc + t_dec),
        "encode_s": t_enc, "decode_s": t_dec, "warm_window_encode_s": warm_s,
        "bpp": 8 * total_bytes / (n_real * h * w), "psnr_db": psnr,
        "decode_bit_exact": bit_exact, "finite": finite,
        "x_hat_shape": list(x_hats.shape), "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        **(extra or {}),
    }
    emit(row)
    if not bit_exact:
        raise AssertionError("decode does not reproduce the encoder's reconstructions")
    if not finite or list(x_hats.shape) != [n_real, h, w, 3]:
        raise AssertionError(f"bad reconstructions: finite={finite} shape={x_hats.shape}")
    for k in kernels:
        if launches[k] == 0:
            raise AssertionError(f"{phase_name} launched no {k} kernel")
    return row


class LaunchLog:
    """Stands in for a kernel's loaded library (the wrappers reach it
    through ``_get_lib()``): records the shape arguments of every launch of
    ``fn``, then launches. ``dims`` picks them from the C call's arguments
    (a slice, or a function of the argument tuple)."""

    def __init__(self, lib, fn: str, dims):
        self._lib, self._fn, self._dims = lib, fn, dims
        self.shapes: set = set()

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != self._fn:
            return fn

        def launch(*args):
            dims = self._dims(args) if callable(self._dims) else args[self._dims]
            self.shapes.add(tuple(dims))
            return fn(*args)

        return launch


def epilogue_key(args) -> tuple:
    """The shape of an epilogue launch from its C call's arguments: (bf16,
    bias, residual, n, C, channel stride, activation code, slope)."""
    return (args[1], args[2] is not None, args[3] is not None, *args[5:10])


def log_launches() -> dict:
    """Put a LaunchLog in front of each built kernel library. Keys: warp
    (B, H, W, C, sx, sy, zero, y0, H_out), deform (B, H, W, G, Cg, Og, K, y0,
    H_out), epilogue (:func:`epilogue_key`)."""
    from tpuvc_torch.ops import deform, epilogue, warp

    warp._lib = LaunchLog(warp._get_lib(), "tpuvc_warp_bilinear_nhwc", slice(3, 12))
    deform._lib = LaunchLog(deform._get_lib(), "tpuvc_deform_conv_nhwc", slice(6, 15))
    epilogue._lib = LaunchLog(epilogue._get_lib(), "tpuvc_epilogue", epilogue_key)
    return {"warp": warp._lib.shapes, "deform": deform._lib.shapes,
            "epilogue": epilogue._lib.shapes}


def path_shapes_check(torch, logged: dict, warp_rows, deform_rows,
                      epilogue_rows=()) -> list[dict]:
    """Every warp, deform and epilogue shape a path launched that
    warp_check, deform_check and epilogue_check did not hold against the
    plain versions (SPyNet's middle pyramid levels, a spatial rank's rows,
    every conv's epilogue, for three): the kernel against warp_plain's
    sampling (bit for bit), deform_plain (smooth +-5 px offsets, <= 2e-5; a
    launch of rows [y0, y0 + H_out) also bit for bit against those rows of a
    whole-frame launch) and epilogue_plain (bit for bit, the conv output
    laid out as the launch had it) once, on seeded inputs."""
    from tpuvc_torch.ops import deform as D
    from tpuvc_torch.ops import epilogue as E
    from tpuvc_torch.ops import warp as W

    checked_warp = set()
    for r in warp_rows:
        B, H, Wd, C = r["shape"]
        sx, sy, zero = W._scales(r["compat"], H, Wd)
        checked_warp.add((B, H, Wd, C, sx, sy, int(zero), r["y0"], r["rows"]))
    checked_deform = {(*r["x_shape"][:3], r["groups"], r["x_shape"][3] // r["groups"],
                       r["out_channels"] // r["groups"], 3, r["y0"], r["rows"])
                      for r in deform_rows}
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for key in sorted(logged["warp"] - checked_warp):
        B, H, Wd, C, sx, sy, zero, y0, rows_out = key
        img = torch.rand((B, H, Wd, C), generator=gen, device="cuda")
        flow = 4.0 * torch.randn((B, rows_out, Wd, 2), generator=gen, device="cuda")
        out_k = W.warp_kernel(img, flow, sx, sy, bool(zero), y0)
        out_p = W._warp_plain_sampled(img, flow - 0.5 if zero else flow, sx, sy, bool(zero), y0)
        rows.append({"phase": "path_shapes_check", "kernel": "warp", "shape": [B, H, Wd, C],
                     "y0": y0, "rows": rows_out, "sx": sx, "sy": sy, "zero": bool(zero),
                     "max_abs_err": float((out_k - out_p).abs().max()),
                     "bit_exact": bool(torch.equal(out_k, out_p))})
        emit(rows[-1])
        if not rows[-1]["bit_exact"]:
            raise AssertionError(f"warp at a path's shape differs from warp_plain: {rows[-1]}")
    for key in sorted(logged["deform"] - checked_deform):
        B, H, Wd, G, Cg, Og, K, y0, rows_out = key
        x, masks, weight, bias = deform_inputs(torch, gen, B, H, Wd, G * Cg, G * Og, G, K * K)
        off = smooth_offsets(torch, gen, B, H, Wd, G * K * K * 2)
        part = [t[:, y0:y0 + rows_out].contiguous() for t in (off, masks)]
        args = (x, part[0], part[1], weight, bias, G, K, y0)
        out_k = D.deform_kernel(*args)
        err = float((out_k - D.deform_plain(*args)).abs().max())
        whole = rows_out == H or bool(torch.equal(
            out_k, D.deform_kernel(x, off, masks, weight, bias, G, K)[:, y0:y0 + rows_out]))
        rows.append({"phase": "path_shapes_check", "kernel": "deform",
                     "x_shape": [B, H, Wd, G * Cg], "groups": G, "out_channels": G * Og,
                     "y0": y0, "rows": rows_out, "spread": "smooth_5px", "max_abs_err": err,
                     "equals_whole_frame_rows": whole})
        emit(rows[-1])
        if not (err <= 2e-5 and whole):
            raise AssertionError(f"deform at a path's shape differs from deform_plain or the "
                                 f"whole frame's rows: {rows[-1]}")
    acts = {code: act for act, code in E._ACTS.items()}
    checked_epilogue = {
        (int(r["dtype"] == "bfloat16"), r["bias"], r["residual"], math.prod(r["shape"]),
         r["shape"][3], 1, E._ACTS[r["act"]], r["slope"]) for r in epilogue_rows}
    torch.cuda.empty_cache()
    with torch.no_grad():
        for key in sorted(logged.get("epilogue", set()) - checked_epilogue, key=repr):
            bf16, has_bias, res, n, C, cstride, code, slope = key
            dtype = torch.bfloat16 if bf16 else torch.float32
            if cstride == 1:  # channels-last memory, split below along its pixels
                y = torch.randn((1, n // C, 1, C), generator=gen, device="cuda", dtype=dtype)
                y, dim = y.permute(0, 3, 1, 2), 2
            else:  # NCHW, cstride pixels a channel, split along its batch; as an
                # (h, w) with no size-one side where cstride has one (a launch that
                # applied the activation to an NCHW output had none)
                h = next((d for d in range(2, math.isqrt(cstride) + 1) if cstride % d == 0),
                         cstride)
                y = torch.randn((n // (C * cstride), C, h, cstride // h), generator=gen,
                                device="cuda", dtype=dtype)
                dim = 0
            bias = torch.randn(C, generator=gen, device="cuda") if has_bias else None
            r = (torch.randn(y.permute(0, 2, 3, 1).shape, generator=gen, device="cuda")
                 if res else None)
            out_k = E.epilogue_kernel(y, bias, acts[code], slope, r)
            # the plain ops are elementwise: held part by part, a few GiB at a time
            step = max(1, math.ceil(y.shape[dim] * min(1.0, 2**28 / n)))
            err, exact = 0.0, True
            for i in range(0, y.shape[dim], step):
                part = (slice(None),) * dim + (slice(i, i + step),)
                part_nhwc = tuple(part[k] if k < len(part) else slice(None)
                                  for k in (0, 2, 3, 1))
                out_p = E.epilogue_plain(y[part], bias, acts[code], slope,
                                         None if r is None else r[part_nhwc])
                got = out_k[part_nhwc]
                err = max(err, float((got - out_p).abs().nan_to_num(0.0).max()))
                exact = exact and bool(torch.equal(got.contiguous().view(torch.int32),
                                                   out_p.contiguous().view(torch.int32)))
            rows.append({"phase": "path_shapes_check", "kernel": "epilogue", "bf16": bool(bf16),
                         "bias": has_bias, "residual": res, "n": n, "C": C,
                         "cstride": cstride, "act": acts[code], "slope": slope,
                         "max_abs_err": err, "bit_exact": exact})
            del y, bias, r, out_k, out_p, got
            if n > 2**28:
                torch.cuda.empty_cache()
            if not rows[-1]["bit_exact"]:
                emit(rows[-1])
                raise AssertionError(f"epilogue at a path's shape differs from epilogue_plain: "
                                     f"{rows[-1]}")
    emit({"phase": "path_shapes_check", "warp_shapes_launched": len(logged["warp"]),
          "deform_shapes_launched": len(logged["deform"]),
          "epilogue_shapes_launched": len(logged.get("epilogue", ())),
          "epilogue_checked_here": sum(r["kernel"] == "epilogue" for r in rows),
          "checked_here": len(rows)})
    return rows


def reset_launches() -> None:
    from tpuvc_torch.ops import deform, epilogue, warp

    warp.warp_kernel.launches = 0
    deform.deform_kernel.launches = 0
    epilogue.epilogue_kernel.launches = 0


def read_launches() -> dict:
    from tpuvc_torch.ops import deform, epilogue, warp

    return {"warp": warp.warp_kernel.launches, "deform": deform.deform_kernel.launches,
            "epilogue": epilogue.epilogue_kernel.launches}


def main_path(torch) -> dict:
    """LHBDC(N=128), seeded weights, at batch 4 (bench.py's window)."""
    from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder

    model = LHBDC(N=128, generator=torch.Generator().manual_seed(0))
    coder = LHBDCCoder(model, device="cuda")
    return drive_window(torch, coder, "main_path", "LHBDC(N=128) seeded weights",
                        B=4, family="lhbdc", kernels=["warp"])


def main_path_v4(torch) -> dict:
    """FlowGuidedB at full width, seeded weights and heads, at batch 2
    (scripts/bench_families.py's v4 window: s=1.0, get_scales per chunk,
    down_ratio 1). The warm window's first chunk measures the flow's and
    the offsets' spread, which must be fractional and nonzero."""
    from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder

    model = v4_model(torch)
    coder = FlowGuidedBCoder(model, device="cuda")
    spread = {}
    hooks = spread_hooks(torch, model, spread)
    row = drive_window(
        torch, coder, "main_path_v4",
        "FlowGuidedB fc (64,96,128) N=M=128 levels 5, seeded weights and heads",
        B=2, family="flowguided_b", kernels=["warp", "deform"],
        after_warm=lambda: [h.remove() for h in hooks],
        extra={"s": 1.0, "down_ratio": 1, "offset_spread": spread},
    )
    check_spread(spread, "main_path_v4")
    return row


def main_path_v3(torch) -> dict:
    """DeformB at full width, seeded weights and offset heads, at batch 2,
    s=1.0 (all six deform convs a B-frame run the kernel's <4, 8>
    instance). The warm window's first chunk measures the offsets'
    spread, which must be fractional and nonzero."""
    from tpuvc_torch.models.deform_b import DeformBCoder

    model = v3_model(torch)
    coder = DeformBCoder(model, device="cuda")
    spread = {}
    hooks = spread_hooks(torch, model, spread)
    row = drive_window(
        torch, coder, "main_path_v3",
        "DeformB fc (32,64,96) N=M=128 levels 5, seeded weights and offset heads",
        B=2, family="deform_b", kernels=["deform"],
        after_warm=lambda: [h.remove() for h in hooks],
        extra={"s": 1.0, "offset_spread": spread},
    )
    check_spread(spread, "main_path_v3", "deform_b")
    return row


def main_path_flexrate(torch) -> dict:
    """Flex-Rate's BidirFlowRef (N=128, 6 gain levels), seeded weights and
    flow refinement, at batch 4, (n, l) = (1, 1.0): four flexrate warps a
    B-frame. The warm window's first chunk measures the predicted flow's
    and the coded refinement's spread."""
    from tpuvc_torch.models.flexrate import FlexRateCoder

    model = flexrate_model(torch)
    coder = FlexRateCoder(model, device="cuda")
    spread = {}
    hooks = spread_hooks(torch, model, spread)
    row = drive_window(
        torch, coder, "main_path_flexrate",
        "Flex-Rate BidirFlowRef N=128 n_levels 6, seeded weights and refinement",
        B=4, family="flexrate", kernels=["warp"],
        after_warm=lambda: [h.remove() for h in hooks],
        extra={"n": 1, "l": 1.0, "flow_spread": spread},
    )
    check_spread(spread, "main_path_flexrate", "flexrate")
    return row


# main_path_dmc's chain: P-frames at down ratio 1.0, then at the fractional
# ratio, and the warm-up chain before them.
DMC_CHAIN = ((1.0, 8), (1.5, 4))
DMC_WARM = ((1.0, 2), (1.5, 1))


def code_p_chain(torch, coder, frames, dpb, runs, q=0.0):
    """Encode ``runs`` ((ratio, n) pairs) of chained P-frames from ``dpb``
    with encode_async (at most 4 streams pending, as encode_p), then decode
    each run with decode_sequence from the decoder's own DPB. Returns
    (per run: (ratio, streams, encode s, decode s, encoder recons, decoded
    recons, warp launches)); the recons are clamped, as each side's DPB
    holds them."""
    enc_dpb, dec_dpb = dpb, dict(dpb)
    i, out = 0, []
    for ratio, n in runs:
        warps = read_launches()["warp"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs, recons = [], []
        for _ in range(n):
            i += 1
            if len([f for f in futs if not f.done()]) >= 4:
                futs[-4].result()
            fut, enc_dpb = coder.encode_async(frames(i), enc_dpb, ratio=ratio, q=q)
            futs.append(fut)
            recons.append(enc_dpb["ref_frame"])
        bits = [f.result() for f in futs]
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        xs, dec_dpb = coder.decode_sequence(dec_dpb, bits)
        dec = [torch.clamp(x, 0.0, 1.0) for x in xs]
        torch.cuda.synchronize()
        out.append((ratio, bits, t_enc, time.perf_counter() - t0, recons, dec,
                    read_launches()["warp"] - warps))
    return out


def main_path_dmc(torch) -> dict:
    """PFrameDMC(feat=48, N=64), seeded weights, at batch 1 and q=0, from a
    DPB on source frame 0 (bench.py's window starts between source anchors):
    DMC_WARM's chain warms cuDNN and the allocator, then DMC_CHAIN's is
    timed with the launch counts set to 0 just before and read just after.
    Every decoded frame must equal the encoder's reconstruction; SPyNet's
    flow and the decoded MV of the first warm frame must be fractional."""
    from tpuvc_torch.data.uvg import SyntheticSequence, device_frame
    from tpuvc_torch.models.dmc import PFrameDMCCoder

    h, w = FRAME
    n = sum(k for _, k in DMC_CHAIN)
    release_cache(torch)  # the evals before it leave tens of GiB cached
    src = SyntheticSequence(n_frames=n + 1, h=h, w=w)
    frames = lambda i: device_frame(src.u8(i), "cuda")  # noqa: E731
    model = dmc_model(torch)
    coder = PFrameDMCCoder(model, device="cuda")
    dpb = {"ref_frame": frames(0), "ref_feature": None, "ref_down_ratio": 1.0}
    spread = {}
    hooks = spread_hooks(torch, model, spread)
    try:
        warm = code_p_chain(torch, coder, frames, dpb, DMC_WARM)
        for hk in hooks:
            hk.remove()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        runs = code_p_chain(torch, coder, frames, dpb, DMC_CHAIN)
        launches = read_launches()
    finally:
        coder.close()
    bit_exact = all(torch.equal(a, b) for r in warm + runs for a, b in zip(r[4], r[5]))
    recons = torch.cat([x for r in runs for x in r[4]])
    finite = bool(torch.isfinite(recons).all())
    src_x = torch.cat([frames(i) for i in range(1, n + 1)])
    psnr = float((10 * torch.log10(1.0 / ((recons - src_x) ** 2).mean(dim=(1, 2, 3)))).mean())
    per_ratio = {
        str(ratio): {"p_frames": len(bits), "encode_fps": len(bits) / t_enc,
                     "decode_fps": len(bits) / t_dec, "encode_s": t_enc, "decode_s": t_dec,
                     "bpp": 8 * sum(b.num_bytes for b in bits) / (len(bits) * h * w),
                     "warp_launches": warps}
        for ratio, bits, t_enc, t_dec, _, _, warps in runs
    }
    t_enc, t_dec = sum(r[2] for r in runs), sum(r[3] for r in runs)
    row = {
        "phase": "main_path_dmc", "model": "PFrameDMC feat 48 N 64, seeded weights",
        "frame": [h, w], "batch": 1, "q": 0.0, "compute_dtype": "float32",
        "p_frames": n, "encode_fps": n / t_enc, "decode_fps": n / t_dec,
        "encdec_fps": 2 * n / (t_enc + t_dec), "per_ratio": per_ratio,
        "bpp": 8 * sum(b.num_bytes for r in runs for b in r[1]) / (n * h * w),
        "psnr_db": psnr, "decode_bit_exact": bit_exact, "finite": finite,
        "x_hat_shape": list(recons.shape), "launches": launches, "mv_spread": spread,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(row)
    if not bit_exact:
        raise AssertionError("main_path_dmc: decode does not reproduce the encoder's frames")
    if not finite or list(recons.shape) != [n, h, w, 3]:
        raise AssertionError(f"main_path_dmc: bad reconstructions, shape {recons.shape}")
    if [b.ratio_centi for r in runs for b in r[1]] != [
            round(100 * ratio) for ratio, k in DMC_CHAIN for _ in range(k)]:
        raise AssertionError("main_path_dmc: a stream carries the wrong down ratio")
    if launches["warp"] == 0:
        raise AssertionError("main_path_dmc launched no warp kernel")
    check_spread(spread, "main_path_dmc", "dmc")
    return row


#: The kernels each family's path must launch.
FAMILY_KERNELS = {"lhbdc": ["warp"], "flowguided_b": ["warp", "deform"],
                  "deform_b": ["deform"], "flexrate": ["warp"], "dmc": ["warp"], "elic": []}

# The CLI runs of sequence_cli: (path name, family, encode_v arguments).
# LHBDC takes bench.py's window settings with real ELIC anchors, 17 frames
# (one GOP; 33 until the smoke's time limit asked for the cut); FlowGuidedB
# runs the sequential mode, at down ratio 1 and with the per-frame
# down-ratio search (--adaptive), 9 frames, one GOP-8 (17 frames, one
# GOP-16, until the smoke's time limit asked for the cut).
SEQUENCE_V4 = ["--family", "flowguided_b", "--synthetic", "9", "--gop", "8",
               "--compute_dtype", "bfloat16", "--s", "1.0"]
SEQUENCE_RUNS = [
    ("lhbdc", "lhbdc", [
        "--family", "lhbdc", "--synthetic", "17", "--gop", "16", "--level_batched",
        "--max_batch", "4", "--window_gops", "2", "--compute_dtype", "bfloat16",
        "--l", "845"]),
    ("flowguided_b", "flowguided_b", SEQUENCE_V4),
    ("flowguided_b_adaptive", "flowguided_b", SEQUENCE_V4 + ["--adaptive"]),
]
# DeformB and Flex-Rate take their windows' batch caps (main_path_v3,
# main_path_flexrate) with real ELIC anchors, level-batched, 9 frames, one
# GOP-8 a window (33 frames, two GOP-16, until PR 14; 17 frames, one GOP-16,
# until the smoke's time limit asked for the cut).
SEQUENCE_RUNS_V3_FLEXRATE = [
    ("deform_b", "deform_b", [
        "--family", "deform_b", "--synthetic", "9", "--gop", "8", "--level_batched",
        "--max_batch", "2", "--window_gops", "1", "--compute_dtype", "bfloat16",
        "--s", "1.0"]),
    ("flexrate", "flexrate", [
        "--family", "flexrate", "--synthetic", "9", "--gop", "8", "--level_batched",
        "--max_batch", "4", "--window_gops", "1", "--compute_dtype", "bfloat16",
        "--n", "1", "--interp", "0.66"]),
]
SEQUENCE_SIZE = ["--width", str(FRAME[1]), "--height", str(FRAME[0])]
SEQUENCE_MODEL = ["--init", "random", "--device", "cuda"]

# Run in a fresh interpreter by sequence_cli, sequence_cli_dmc and
# decode_under_memory_pressure, from the repository root: the main of the
# coding CLI named by the first argument (decode_v or decode_p; also
# encode_v or encode_p) on the other arguments, once (the process's first
# card work), with the zero-initialised heads seeded as in the encoder,
# printing the launches, wall seconds, the card's free memory at start,
# peak memory, the allocator's out-of-memory count and one sha256 per
# float32 reconstruction as the last line.
DECODE_IN_A_NEW_PROCESS = """
import hashlib, importlib, json, sys, time
import torch
import chip_smoke
free0 = torch.cuda.mem_get_info()[0]
cli = importlib.import_module("tpuvc_torch.cli." + sys.argv[1])
t0 = time.perf_counter()
with chip_smoke.cli_heads_seeded():
    rec = cli.main(sys.argv[2:])
print(json.dumps({
    "main_s": time.perf_counter() - t0,
    "launches": chip_smoke.read_launches(),
    "free_gib_at_start": free0 / 2**30,
    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    "num_ooms": torch.cuda.memory_stats().get("num_ooms", 0),
    "sha256": {i: hashlib.sha256(t.numpy().tobytes()).hexdigest() for i, t in rec.items()},
}))
"""

# A ballast process: holds all of the card but argv[1] GiB, prints the GiB
# it holds, and keeps them until its standard input closes.
BALLAST_PROCESS = """
import sys, torch
free = torch.cuda.mem_get_info()[0]
hold = torch.empty(max(free - int(float(sys.argv[1]) * 2**30), 0), dtype=torch.uint8,
                   device="cuda")
print(hold.numel() / 2**30, flush=True)
sys.stdin.read()
"""


@contextlib.contextmanager
def ballast(leave_gib: float):
    """A ballast process holding all of the card but ``leave_gib`` GiB for
    the enclosed code; yields the GiB it holds."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-c", BALLAST_PROCESS, str(leave_gib)], cwd=root,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        held = proc.stdout.readline()
        if not held:
            raise AssertionError("the ballast process did not start")
        yield float(held)
    finally:
        proc.stdin.close()
        proc.wait(timeout=60)


def cli_seconds(text: str, verb: str) -> float:
    """The coding time a CLI prints on its summary line ("<verb> ... in Ts")."""
    import re

    found = re.findall(rf"^{verb} .* in ([0-9.]+)s$", text, flags=re.M)
    if not found:
        raise AssertionError(f"no '{verb} ... in Ts' line in the CLI's output")
    return float(found[-1])


def down_ratio_histogram(text: str) -> dict:
    """{down ratio: frames} from encode_v --adaptive's per-frame lines."""
    import collections
    import re

    found = re.findall(r"^  frame +\d+: down_ratio (\d+)$", text, flags=re.M)
    if not found:
        raise AssertionError("encode_v --adaptive printed no down ratio")
    return dict(sorted(collections.Counter(int(r) for r in found).items()))


def keep_stream(streams, path: str, verb: str, bin_path: str, dec_argv: list,
                hashes: dict, peak_gib: float) -> None:
    """Copy a sequence run's stream into ``streams["dir"]`` and record how
    to decode it (for decode_under_memory_pressure), where ``streams`` is
    given and names ``path``."""
    import shutil

    if streams is None or path not in streams["paths"]:
        return
    kept = os.path.join(streams["dir"], os.path.basename(bin_path))
    shutil.copy(bin_path, kept)
    argv = [kept if a == bin_path else a for a in dec_argv]
    argv[argv.index("--out_dir") + 1] = os.path.join(streams["dir"], f"{path}_png")
    streams[path] = {"verb": verb, "argv": argv, "sha256": hashes,
                     "peak_mem_gib_decode": peak_gib}


def sequence_cli(torch, runs, intra: bool = True, streams=None) -> list[dict]:
    """For each of ``runs`` (SEQUENCE_RUNS' form): encode_v in this process
    (a warm-up call, then a timed one with the launch counts set to 0 just
    before and read just after), decode_v on the file in a fresh process
    (DECODE_IN_A_NEW_PROCESS), whose per-frame sha256 must equal the
    encoder's; then, with ``intra``, ELIC alone at batch 3 on the window's
    three anchors. The zero-initialised heads of SEEDED_FAMILIES are seeded
    in both processes (cli_heads_seeded): the run fails unless their flows
    and offsets are fractional. ``streams``: see keep_stream."""
    import hashlib
    import io
    import tempfile

    import numpy as np

    from tpuvc_torch.cli import encode_v
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import VSequenceBitstream
    from tpuvc_torch.data.uvg import SyntheticSequence, device_frame
    from tpuvc_torch.eval.metrics import psnr_uint8_np
    from tpuvc_torch.ops.precision import policy_from_name

    h, w = FRAME
    root = os.path.dirname(os.path.abspath(__file__))
    rows = []
    src = SyntheticSequence(n_frames=2 * GOP + 1, h=h, w=w)  # encode_v's frames
    with tempfile.TemporaryDirectory() as tmp:
        for path, family, argv in runs:
            bin_path = os.path.join(tmp, f"{path}.tpvb")
            enc_argv = argv + SEQUENCE_SIZE + SEQUENCE_MODEL + ["--bin", bin_path]
            spread = {}
            try:
                with cli_heads_seeded(spread):
                    with contextlib.redirect_stdout(io.StringIO()):
                        encode_v.main(enc_argv)  # warm-up
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    log = io.StringIO()
                    reset_launches()
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(log):
                        recons = encode_v.main(enc_argv)
                    main_s = time.perf_counter() - t0
                    enc_launches = read_launches()
            finally:
                parallel.shutdown()
            enc_peak = torch.cuda.max_memory_allocated() / 2**30
            enc_hashes = {str(i): hashlib.sha256(t.numpy().tobytes()).hexdigest()
                          for i, t in recons.items()}
            with open(bin_path, "rb") as f:
                blob = f.read()
            seq = VSequenceBitstream.deserialize(blob)
            n = seq.n_frames
            if len(src) < n:
                src = SyntheticSequence(n_frames=n, h=h, w=w)
            psnr = float(np.mean([psnr_uint8_np(src.u8(i)[0, :h, :w], recons[i].numpy())
                                  for i in range(n)]))
            finite = all(bool(torch.isfinite(t).all()) and tuple(t.shape) == (h, w, 3)
                         for t in recons.values())
            del recons

            dec_argv = ["--bin", bin_path, "--out_dir", os.path.join(tmp, f"{path}_png")]
            proc = subprocess.run(
                [sys.executable, "-c", DECODE_IN_A_NEW_PROCESS, "decode_v", *dec_argv,
                 *SEQUENCE_MODEL],
                cwd=root, capture_output=True, text=True, timeout=420,
            )
            if proc.returncode != 0:
                raise AssertionError(f"decode_v ({path}) failed:\n{proc.stderr[-4000:]}")
            dec = json.loads(proc.stdout.strip().splitlines()[-1])
            bit_exact = dec["sha256"] == enc_hashes
            keep_stream(streams, path, "decode_v", bin_path, dec_argv + SEQUENCE_MODEL,
                        enc_hashes, dec["peak_mem_gib"])
            enc_s = cli_seconds(log.getvalue(), "wrote")
            dec_s = cli_seconds(proc.stdout, "decoded")
            png_s = cli_seconds(proc.stdout, "wrote")
            n_i = sum(1 for t, _, _ in seq.frames if t == "I")
            launches = {k: enc_launches[k] + dec["launches"][k] for k in enc_launches}
            row = {
                "phase": "sequence_cli", "path": path, "family": family,
                "encode_argv": argv, "frame": [h, w], "gop": seq.gop,
                "frames": n, "i_frames": n_i, "b_frames": n - n_i,
                "level_batched": seq.mode == 1, "max_batch": seq.max_batch,
                "window_gops": seq.window_gops,
                "compute_dtype": "bfloat16" if seq.dtype == 1 else "float32",
                "encode_s": enc_s, "encode_fps": n / enc_s, "encode_main_s": main_s,
                "decode_s": dec_s, "decode_fps": n / dec_s,
                # decode_s includes writing the PNGs (zlib on the host):
                # without it, the codec's own decode rate
                "decode_png_s": png_s, "decode_fps_without_png": n / (dec_s - png_s),
                "decode_main_s": dec["main_s"],
                "bytes": len(blob), "bpp": 8 * len(blob) / (n * h * w), "psnr_db": psnr,
                "decode_bit_exact": bit_exact, "decoder": "separate process",
                "finite": finite, "launches": launches,
                "launches_encode": enc_launches,
                "launches_decode": dec["launches"],
                "peak_mem_gib_encode": enc_peak,
                "peak_mem_gib_decode": dec["peak_mem_gib"],
            }
            if family in SEEDED_FAMILIES:
                row["flow_offset_spread"] = spread
            if "--adaptive" in argv:
                row["down_ratios"] = down_ratio_histogram(log.getvalue())
            rows.append(row)
            if not bit_exact:
                emit(row)
                raise AssertionError(f"sequence_cli {path}: the decoder's frames differ")
            if not finite:
                emit(row)
                raise AssertionError(f"sequence_cli {path}: bad reconstructions")
            if family in SEEDED_FAMILIES:
                try:
                    check_spread(spread, f"sequence_cli {path}", family)
                except AssertionError:
                    emit(row)
                    raise
            for k in FAMILY_KERNELS[family]:
                if enc_launches[k] == 0 or dec["launches"][k] == 0:
                    emit(row)
                    raise AssertionError(f"sequence_cli {path} launched no {k} kernel")

        if not intra:
            for row in rows:
                emit(row)
            return rows
        # ELIC alone at batch 3: the 2-GOP window's fresh anchors 0, 16, 32.
        args = encode_v.build_parser().parse_args(SEQUENCE_MODEL)
        intra = encode_v.build_intra(args, torch.device("cuda"))
        x = torch.cat([device_frame(src.u8(i), "cuda") for i in (0, GOP, 2 * GOP)])
        try:
            with policy_from_name("bfloat16"):
                for _ in range(2):  # the first pair warms up
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    enc = intra.compress_batch(x)
                    y_hat = intra.synthesize(enc["y_hat"])
                    torch.cuda.synchronize()
                    t_enc = time.perf_counter() - t0
                    dec = intra.decompress_batch(enc["strings"], enc["shape"])
                    torch.cuda.synchronize()
                    t_dec = time.perf_counter() - t0 - t_enc
        finally:
            parallel.shutdown()
        intra_exact = bool(torch.equal(dec, y_hat))
    intra_row = {"intra_encode_ms_per_frame": 1e3 * t_enc / 3,
                 "intra_decode_ms_per_frame": 1e3 * t_dec / 3,
                 "intra_batch": 3, "intra_bit_exact": intra_exact,
                 "intra_model": "ELIC N=192 M=320 groups (16,16,32,64,192), seeded"}
    for row in rows:
        row.update(intra_row)
        emit(row)
    if not intra_exact:
        raise AssertionError("ELIC decompress_batch differs from the encoder's synthesis")
    return rows


# sequence_cli_dmc's encode_p run: an I-frame and 4 P-frames (8 until the
# smoke's time limit asked for the cut), each P-frame's down ratio searched
# over encode_p's default candidates (1.0, 1.25, 1.5, 2.0, 3.0, 4.0), q=0,
# float32 (encode_p has no dtype policy).
SEQUENCE_DMC = ["--synthetic", str(GOP // 4 + 1), "--adaptive"]


def release_cache(torch) -> float:
    """Hand this process's cached device memory back to the card, so that a
    subprocess has it; returns the GiB still reserved."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**30


def sequence_cli_dmc(torch, streams=None) -> dict:
    """encode_p as a user runs it, timed, with the launch counts set to 0
    just before and read just after (no warm-up call: main_path_dmc ran the
    same model and shapes in this process), decode_p on the file in a fresh
    process (DECODE_IN_A_NEW_PROCESS), whose per-frame sha256 must equal the
    encoder's; then ELIC alone at batch 1 (the I-frame of a P sequence),
    float32. ``streams``: see keep_stream (path "dmc")."""
    import collections
    import hashlib
    import io
    import re
    import tempfile

    import numpy as np

    from tpuvc_torch.cli import encode_p, encode_v
    from tpuvc_torch.coder.container import PSequenceBitstream
    from tpuvc_torch.data.uvg import SyntheticSequence, device_frame
    from tpuvc_torch.eval.metrics import psnr_uint8_np

    h, w = FRAME
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        bin_path = os.path.join(tmp, "dmc.tpvs")
        enc_argv = SEQUENCE_DMC + SEQUENCE_SIZE + SEQUENCE_MODEL + ["--bin", bin_path]
        release_cache(torch)
        torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            recons = encode_p.main(enc_argv)
        main_s = time.perf_counter() - t0
        enc_launches = read_launches()
        enc_peak = torch.cuda.max_memory_allocated() / 2**30
        enc_hashes = {str(i): hashlib.sha256(t.numpy().tobytes()).hexdigest()
                      for i, t in recons.items()}
        with open(bin_path, "rb") as f:
            blob = f.read()
        seq = PSequenceBitstream.deserialize(blob)
        n = len(seq.frames)
        src = SyntheticSequence(n_frames=n, h=h, w=w)
        psnr = float(np.mean([psnr_uint8_np(src.u8(i)[0, :h, :w], recons[i].numpy())
                              for i in range(n)]))
        finite = all(bool(torch.isfinite(t).all()) and tuple(t.shape) == (h, w, 3)
                     for t in recons.values())
        del recons
        reserved_gib = release_cache(torch)
        dec_argv = ["--bin", bin_path, "--out_dir", os.path.join(tmp, "png"), *SEQUENCE_MODEL]
        proc = subprocess.run(
            [sys.executable, "-c", DECODE_IN_A_NEW_PROCESS, "decode_p", *dec_argv],
            cwd=root, capture_output=True, text=True, timeout=420,
        )
        if proc.returncode != 0:
            raise AssertionError(f"decode_p failed:\n{proc.stderr[-4000:]}")
        dec = json.loads(proc.stdout.strip().splitlines()[-1])
        keep_stream(streams, "dmc", "decode_p", bin_path, dec_argv, enc_hashes,
                    dec["peak_mem_gib"])
    bit_exact = dec["sha256"] == enc_hashes
    chosen = re.findall(r"^frame +\d+ P ratio ([0-9.]+)$", log.getvalue(), flags=re.M)
    enc_s = cli_seconds(log.getvalue(), "wrote")
    dec_s = cli_seconds(proc.stdout, "decoded")
    png_s = cli_seconds(proc.stdout, "wrote")

    # ELIC alone at batch 1 on the sequence's first frame: a warm-up, then timed.
    args = encode_p.build_parser().parse_args(SEQUENCE_MODEL)
    intra = encode_v.build_intra(args, torch.device("cuda"))
    x = device_frame(src.u8(0), "cuda")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = intra.compress(x)
        y_hat = intra.synthesize(enc["y_hat"])
        torch.cuda.synchronize()
        t_ienc = time.perf_counter() - t0
        dec_i = intra.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        t_idec = time.perf_counter() - t0 - t_ienc
    intra_exact = bool(torch.equal(dec_i, y_hat))

    n_i = sum(1 for t, _ in seq.frames if t == "I")
    row = {
        "phase": "sequence_cli_dmc", "encode_argv": SEQUENCE_DMC, "frame": [h, w],
        "frames": n, "i_frames": n_i, "p_frames": n - n_i, "compute_dtype": "float32",
        "encode_s": enc_s, "encode_fps": n / enc_s, "encode_main_s": main_s,
        "decode_s": dec_s, "decode_fps": n / dec_s, "decode_png_s": png_s,
        "decode_fps_without_png": n / (dec_s - png_s),
        "decode_main_s": dec["main_s"],
        "bytes": len(blob), "bpp": 8 * len(blob) / (n * h * w), "psnr_db": psnr,
        "down_ratios": dict(sorted(collections.Counter(float(r) for r in chosen).items())),
        "decode_bit_exact": bit_exact, "decoder": "separate process", "finite": finite,
        "launches_encode": enc_launches, "launches_decode": dec["launches"],
        "launches": {k: enc_launches[k] + dec["launches"][k] for k in enc_launches},
        "peak_mem_gib_encode": enc_peak, "peak_mem_gib_decode": dec["peak_mem_gib"],
        "encoder_process_reserved_gib": reserved_gib,
        "intra_encode_ms_per_frame": 1e3 * t_ienc, "intra_decode_ms_per_frame": 1e3 * t_idec,
        "intra_batch": 1, "intra_bit_exact": intra_exact,
        "intra_model": "ELIC N=192 M=320 groups (16,16,32,64,192), seeded, float32",
    }
    emit(row)
    if not (bit_exact and finite and intra_exact):
        raise AssertionError("sequence_cli_dmc: the decoder's frames differ or are bad")
    if len(chosen) != n - n_i:
        raise AssertionError(f"sequence_cli_dmc: {len(chosen)} searched ratios for {n - n_i} P")
    if enc_launches["warp"] == 0 or dec["launches"]["warp"] == 0:
        raise AssertionError("sequence_cli_dmc launched no warp kernel")
    return row


#: decode_under_memory_pressure's streams: a B family's (DeformB, from
#: sequence_cli_v3_flexrate) and DMC's (sequence_cli_dmc); the memory the
#: ballast leaves beyond the decoder's peak and the conv-workspace budget.
PRESSURE_PATHS = ("deform_b", "dmc")
PRESSURE_EXTRA_GIB = 2


def decode_under_memory_pressure(torch, streams: dict) -> list[dict]:
    """Each of PRESSURE_PATHS' streams decoded again in a fresh process
    while a ballast process holds all of the card but the decoder's own
    peak (its sequence row's) + the conv-workspace budget
    (``precision.CONV_WORKSPACE_GIB``) + PRESSURE_EXTRA_GIB: the per-frame
    sha256 must equal the encoder's (scripts/plan_memory_experiment.py
    runs the same for every coding family)."""
    from tpuvc_torch.ops.precision import CONV_WORKSPACE_GIB

    root = os.path.dirname(os.path.abspath(__file__))
    release_cache(torch)
    rows = []
    for path in PRESSURE_PATHS:
        s = streams[path]
        leave = s["peak_mem_gib_decode"] + CONV_WORKSPACE_GIB + PRESSURE_EXTRA_GIB
        with ballast(leave) as held:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", DECODE_IN_A_NEW_PROCESS, s["verb"],
                                   *s["argv"]], cwd=root, capture_output=True, text=True,
                                  timeout=420)
            wall_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{s['verb']} ({path}) under memory pressure failed:\n"
                                 f"{proc.stderr[-4000:]}")
        dec = json.loads(proc.stdout.strip().splitlines()[-1])
        row = {"phase": "decode_under_memory_pressure", "path": path, "verb": s["verb"],
               "frames": len(s["sha256"]), "ballast_gib": held, "left_gib": leave,
               "conv_workspace_budget_gib": CONV_WORKSPACE_GIB,
               "decoder_free_gib_at_start": dec["free_gib_at_start"],
               "peak_mem_gib_alone": s["peak_mem_gib_decode"],
               "peak_mem_gib": dec["peak_mem_gib"], "num_ooms": dec["num_ooms"],
               "wall_s": wall_s, "launches": dec["launches"],
               "frames_differing": sum(dec["sha256"].get(i) != h
                                       for i, h in s["sha256"].items()),
               "decode_bit_exact": dec["sha256"] == s["sha256"]}
        emit(row)
        rows.append(row)
        if not row["decode_bit_exact"]:
            raise AssertionError(f"decode_under_memory_pressure {path}: the frames differ")
    return rows


# The eval CLI runs of eval_cli: (path name, overrides). FlowGuidedB runs the
# RD-eval default (sequential, per-frame down-ratio search) with MS-SSIM in
# float32; LHBDC runs bench.py's eval_fps settings (level-batched, batch
# cap 8, bfloat16). One 17-frame sequence (one GOP-16) each.
EVAL_RUNS = [
    ("flowguided_b", ["model.family=flowguided_b", "adaptive_down_ratio=True",
                      "eval_msssim=True", "compute_dtype=float32"]),
    ("lhbdc", ["model.family=lhbdc", "level_batched=True", "window_gops=2",
               "max_batch=8", "compute_dtype=bfloat16"]),
]
# DeformB and Flex-Rate level-batched at their windows' batch caps, bfloat16.
EVAL_RUNS_V3_FLEXRATE = [
    ("deform_b", ["model.family=deform_b", "level_batched=True", "window_gops=2",
                  "max_batch=2", "compute_dtype=bfloat16"]),
    ("flexrate", ["model.family=flexrate", "level_batched=True", "window_gops=2",
                  "max_batch=4", "compute_dtype=bfloat16"]),
]
# DMC's low-delay eval: one I-frame (dmc_intra_period 32 > 17 frames), the
# default fractional search over dmc_ratios, float32, the diagnostics CSV.
EVAL_RUNS_DMC = [
    ("dmc", ["model.family=dmc", "dmc_intra_period=32", "dmc_diag_csv=diag.csv"]),
]


def eval_overrides(path: str, out_dir: str) -> list[str]:
    """The eval CLI's overrides for EVAL_RUNS' ``path``: one synthetic
    sequence of GOP + 1 frames at FRAME, level 0, seeded weights (the
    weight directories do not exist), results under ``out_dir``."""
    h, w = FRAME
    return [
        "dataset.name=synthetic", f"dataset.sequences={{'synth': {GOP + 1}}}",
        f"dataset.gop={GOP}", f"dataset.width={w}", f"dataset.height={h}", "levels=(0,)",
        f"output_dir={out_dir}", f"intra_weights={out_dir}/none",
        f"inter_weights={out_dir}/none",
    ] + dict(EVAL_RUNS + EVAL_RUNS_V3_FLEXRATE + EVAL_RUNS_DMC)[path]


def eval_cli(torch, runs, warm: bool = True) -> list[dict]:
    """The port's RD-eval CLI (tpuvc_torch.cli.test) on 17 synthetic
    1088x1920 frames for each of ``runs`` (EVAL_RUNS' form), seeded weights
    (the zero-initialised heads seeded): a warm-up call (unless ``warm`` is
    false, where an earlier phase ran the model at its shapes), then a timed
    one with the launch counts set to 0 just before and read just after. One row
    per run: frames/s over the eval's wall time, peak device memory, the
    per-level PSNR and bpp, the down ratios chosen (for DMC also as its
    diagnostics CSV records them), the launches."""
    import collections
    import csv
    import io
    import math
    import tempfile

    from tpuvc_torch.cli import test as eval_cli_main

    h, w = FRAME
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for path, overrides in runs:
            argv = ["--device", "cuda"] + eval_overrides(path, tmp)
            spread = {}
            with cli_heads_seeded(spread):
                if warm:
                    with contextlib.redirect_stdout(io.StringIO()):
                        eval_cli_main.main(argv)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                with contextlib.redirect_stdout(io.StringIO()):
                    out = eval_cli_main.main(argv)
                torch.cuda.synchronize()
                launches = read_launches()
            info = out["info"]
            per_level = info.per_level()
            row = {
                "phase": "eval_cli", "path": path, "overrides": overrides,
                "frame": [h, w], "gop": GOP, "frames": out["frames"],
                "eval_s": out["seconds"], "frames_per_s": out["frames"] / out["seconds"],
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "per_level": per_level, "per_frame_type": info.per_frame_type(),
                "down_ratios": out["down_ratios"], "launches": launches,
            }
            if "eval_msssim=True" in overrides:
                row["msssim_mean"] = sum(r["msssim"] for r in info.rows) / len(info.rows)
            if path in SEEDED_FAMILIES:
                row["flow_offset_spread"] = spread
            if path == "dmc":
                with open(os.path.join(tmp, "synth_l0_diag.csv")) as f:
                    diag = list(csv.DictReader(f))
                row["diag_down_ratios"] = dict(sorted(collections.Counter(
                    float(r["down_ratio"]) for r in diag if r["type"] == "P").items()))
            emit(row)
            rows.append(row)
            finite = all(math.isfinite(r[k]) for r in info.rows for k in ("psnr", "size"))
            if out["frames"] != GOP + 1 or not finite or not all(r["size"] > 0 for r in info.rows):
                raise AssertionError(f"eval_cli {path}: bad per-frame rows")
            if path in SEEDED_FAMILIES:
                check_spread(spread, f"eval_cli {path}", path)
            searched = {"flowguided_b": GOP - 1, "dmc": GOP}.get(path)
            if searched is not None and sum(out["down_ratios"].values()) != searched:
                raise AssertionError(f"eval_cli {path}: {out['down_ratios']} for {searched} frames")
            if path == "dmc" and row["diag_down_ratios"] != {
                    float(k): v for k, v in out["down_ratios"].items()}:
                raise AssertionError(f"eval_cli dmc: the diagnostics CSV disagrees: {row}")
            for k in FAMILY_KERNELS[path]:
                if launches[k] == 0:
                    raise AssertionError(f"eval_cli {path} launched no {k} kernel")
    return rows


def adaptive_ratios(torch) -> dict:
    """FlowGuidedBCoder.encode_recon at down ratios 2, 4, 8 and 16 at
    1088x1920 (full width, heads seeded, bfloat16 policy): each stream,
    serialised and parsed again, must decode to the encoder's
    reconstruction bit for bit and carry its ratio."""
    import numpy as np

    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import VFrameBitstream
    from tpuvc_torch.data.uvg import SyntheticSequence, device_frame
    from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder
    from tpuvc_torch.ops.precision import policy_from_name

    h, w = FRAME
    coder = FlowGuidedBCoder(v4_model(torch), device="cuda")
    src = SyntheticSequence(n_frames=3, h=h, w=w)
    x1, xc, x2 = (device_frame(src.u8(i), "cuda") for i in range(3))
    per_ratio = {}
    reset_launches()
    try:
        with policy_from_name("bfloat16"):
            for ratio in (2, 4, 8, 16):
                bits, x_hat = coder.encode_recon(x1, x2, xc, 1.0, 0.5, 0.5, down_ratio=ratio)
                blob = bits.serialize()
                dec = coder.decode(x1, x2, VFrameBitstream.deserialize(blob))
                mse = float(((torch.clamp(x_hat, 0, 1) - xc) ** 2).mean())
                per_ratio[ratio] = {
                    "bit_exact": bool(torch.equal(dec, x_hat)),
                    "stream_down_ratio": bits.down_ratio,
                    "bpp": 8 * len(blob) / (h * w), "psnr_db": 10 * np.log10(1 / mse),
                    "finite": bool(torch.isfinite(x_hat).all()),
                }
        launches = read_launches()
    finally:
        parallel.shutdown()
    row = {"phase": "adaptive_ratios", "frame": [h, w], "s": 1.0, "scales": [0.5, 0.5],
           "compute_dtype": "bfloat16", "ratios": per_ratio, "launches": launches}
    emit(row)
    for ratio, r in per_ratio.items():
        if not (r["bit_exact"] and r["finite"] and r["stream_down_ratio"] == ratio):
            raise AssertionError(f"adaptive_ratios: down ratio {ratio}: {r}")
    for k in ("warp", "deform"):
        if launches[k] == 0:
            raise AssertionError(f"adaptive_ratios launched no {k} kernel")
    return row


def bench_torch_run(torch, budget_s: int = 240) -> dict:
    """``python bench_torch.py`` in a subprocess with a wall-clock budget:
    its last record must hold decode_bit_exact true, at least two measured
    windows and eval_fps. This process first hands its cached device memory
    back (the eval phase's batch-8 forward leaves ~60 GiB cached), so the
    benchmark has the card to itself."""
    reserved_gib = release_cache(torch)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TPUVC_BENCH_BUDGET_S=str(budget_s))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "bench_torch.py")],
        cwd=root, env=env, capture_output=True, text=True, timeout=budget_s + 180,
    )
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    if proc.returncode != 0 or len(lines) < 2:
        raise AssertionError(f"bench_torch.py failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    record = lines[-1]
    row = {"phase": "bench_torch", "first_line": lines[0], "record": record,
           "smoke_process_reserved_gib": reserved_gib}
    emit(row)
    if not (record.get("decode_bit_exact") is True and record.get("measured_windows", 0) >= 2
            and "eval_fps" in record and "eval_launches" in record):
        raise AssertionError(f"bench_torch.py's record falls short: {record}")
    return row


# Training (cli/train.py) at tpuvc's defaults: batch 8, 256x256 crops.
# The shapes its kernels run at, held against the plain versions (forward)
# and timed with the backward that training runs (autograd of the plain
# formulation): LHBDC's motion compensation and SPyNet (four flows at B=32),
# Flex-Rate's zero-ring warp, DMC's frame and 48-channel feature warps, the
# v4 feature warps at /2, /4, /8; the v4 and v3 deform convs at /2, /4, /8.
TRAIN_B, TRAIN_CROP = 8, 256
TRAIN_WARP_SHAPES = [
    ("lhbdc", (32, 256, 256, 3)),
    ("lhbdc", (8, 256, 256, 3)),
    ("flexrate", (8, 256, 256, 3)),
    ("exact", (8, 256, 256, 48)),
    ("exact", (8, 128, 128, 64)),
    ("exact", (8, 64, 64, 96)),
    ("exact", (8, 32, 32, 128)),
]
TRAIN_DEFORM_SHAPES = [
    ("v4 L1", (8, 128, 128, 128), 16, 64),
    ("v4 L2", (8, 64, 64, 192), 16, 96),
    ("v4 L3", (8, 32, 32, 256), 16, 128),
    ("v3 L1", (8, 128, 128, 32), 8, 32),
    ("v3 L2", (8, 64, 64, 64), 8, 64),
    ("v3 L3", (8, 32, 32, 96), 8, 96),
]


def _grad_err(torch, got, ref) -> float:
    """Max |got - ref| over max |ref| (0 where both are 0)."""
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    return err / scale if scale else err


def train_kernel_check(torch) -> list[dict]:
    """Each kernel at the training shapes: the forward against the plain
    version (the warp bit for bit, the deform conv within 2e-5), the kernel
    path's gradients (kernel forward, backward by autograd of the plain
    formulation) against the plain version's own (within 1e-5 of the
    gradient's max), two backward passes bit-identical under the train CLI's
    determinism (``precision.deterministic_training``), and the times of the
    kernel forward, of the forward and backward under that mode and without
    deterministic algorithms (float atomics), of the plain forward plus
    backward, and for the warp of ``F.grid_sample``'s forward plus backward;
    the backward's bound counts each of its inputs (the output's gradient,
    the forward's inputs) read once and each gradient written once."""
    import torch.nn.functional as F

    from tpuvc_torch.ops import deform as D
    from tpuvc_torch.ops import warp as W
    from tpuvc_torch.ops.precision import deterministic_training

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []

    def grads_of(fn, inputs, g):
        ins = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*ins), ins, g)

    def backward_times(fn, inputs, g):
        """(ms under the mode, ms without deterministic algorithms, two
        backward passes under the mode bit-identical)."""
        with deterministic_training("cuda"):
            ms = time_ms(torch, lambda: grads_of(fn, inputs, g), 5, 1)
            a, b = grads_of(fn, inputs, g), grads_of(fn, inputs, g)
            same = all(torch.equal(x, y) for x, y in zip(a, b))
        del a, b
        atomics_ms = time_ms(torch, lambda: grads_of(fn, inputs, g), 5, 1)
        return ms, atomics_ms, same

    def bound(n_bytes, ops):
        by_bytes, by_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    for compat, shape in TRAIN_WARP_SHAPES:
        B, H, Wd, C = shape
        img = torch.rand(shape, generator=gen, device="cuda")
        flow = 4.0 * torch.randn((B, H, Wd, 2), generator=gen, device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda")
        grads = []
        for fn in (W.warp, W.warp_plain):
            i, f = img.clone().requires_grad_(), flow.clone().requires_grad_()
            out = fn(i, f, compat)
            grads.append((out.detach(), *torch.autograd.grad(out, (i, f), g)))
        (ok, gik, gfk), (op, gip, gfp) = grads
        n_out, n_flow = B * H * Wd * C, B * H * Wd * 2
        fwd_bound, fwd_by = bound(4 * (2 * n_out + n_flow), WARP_OPS_PER_ELEMENT * n_out)
        # reads the output's gradient, the image and the flow; writes both gradients
        bwd_bound, bwd_by = bound(4 * (3 * n_out + 2 * n_flow), 2 * WARP_OPS_PER_ELEMENT * n_out)
        bwd_ms, atomics_ms, same = backward_times(
            lambda i, f: W.warp(i, f, compat), (img, flow), g)
        # F.grid_sample for the same sampling, forward and backward, as a
        # yardstick (it has no deterministic CUDA backward)
        sx, sy, zero = W._scales(compat, H, Wd)
        shift = -0.5 if zero else 0.0
        xs = torch.arange(Wd, device="cuda", dtype=torch.float32)
        ys = torch.arange(H, device="cuda", dtype=torch.float32)

        def library(i, f):
            gx = (xs + (f[..., 0] + shift) * sx) * (2.0 / (Wd - 1)) - 1.0
            gy = (ys[:, None] + (f[..., 1] + shift) * sy) * (2.0 / (H - 1)) - 1.0
            return F.grid_sample(i.permute(0, 3, 1, 2), torch.stack([gx, gy], dim=-1),
                                 mode="bilinear", padding_mode="zeros" if zero else "border",
                                 align_corners=True).permute(0, 2, 3, 1)

        row = {"phase": "train_kernel_check", "kernel": "warp", "compat": compat,
               "shape": list(shape), "fwd_bit_exact": bool(torch.equal(ok, op)),
               "bound_ms": fwd_bound, "bound_by": fwd_by,
               "img_grad_rel_err": _grad_err(torch, gik, gip),
               "flow_grad_rel_err": _grad_err(torch, gfk, gfp),
               "fwd_ms": time_ms(torch, lambda: W.warp(img, flow, compat), 20),
               "fwd_bwd_ms": bwd_ms, "fwd_bwd_ms_with_atomics": atomics_ms,
               "bwd_repeat_bit_identical": same,
               "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
               "plain_fwd_bwd_ms": time_ms(
                   torch, lambda: grads_of(lambda i, f: W.warp_plain(i, f, compat),
                                           (img, flow), g), 5, 1),
               "library_fwd_bwd_ms": time_ms(
                   torch, lambda: grads_of(library, (img, flow), g), 5, 1)}
        emit(row)
        rows.append(row)
        del img, flow, g, grads, ok, op, gik, gfk, gip, gfp
        if not (row["fwd_bit_exact"] and row["img_grad_rel_err"] <= 1e-5
                and row["flow_grad_rel_err"] <= 1e-5 and same):
            raise AssertionError(f"warp at a training shape disagrees: {row}")
    for level, (B, H, Wd, C), G, C_out in TRAIN_DEFORM_SHAPES:
        x, masks, weight, bias = deform_inputs(torch, gen, B, H, Wd, C, C_out, G)
        off = smooth_offsets(torch, gen, B, H, Wd, G * DEFORM_TAPS * 2)
        g = torch.randn((B, H, Wd, C_out), generator=gen, device="cuda")
        inputs = (x, off, masks, weight, bias)
        grads = []
        for fn in (D.deform_conv2d, D.deform_plain):
            ins = [t.clone().requires_grad_() for t in inputs]
            out = fn(*ins, G, 3)
            grads.append((out.detach(), torch.autograd.grad(out, ins, g)))
        (ok, gk), (op, gp) = grads
        n_in = sum(t.numel() for t in inputs)
        ops = deform_ops(B, H, Wd, G, C // G, C_out // G)
        fwd_bound, fwd_by = bound(4 * (n_in + g.numel()), ops)
        # reads the output's gradient and the inputs; writes a gradient of
        # each input; multiplies and adds twice the forward's (the input's
        # and the weight's gradient)
        bwd_bound, bwd_by = bound(4 * (2 * n_in + g.numel()), 2 * ops)
        bwd_ms, atomics_ms, same = backward_times(
            lambda *t: D.deform_conv2d(*t, G, 3), inputs, g)
        row = {"phase": "train_kernel_check", "kernel": "deform", "level": level,
               "x_shape": [B, H, Wd, C], "groups": G, "out_channels": C_out,
               "bound_ms": fwd_bound, "bound_by": fwd_by,
               "spread": "smooth_5px", "fwd_max_abs_err": float((ok - op).abs().max()),
               "grad_rel_err": {n: _grad_err(torch, a, b) for n, a, b in zip(
                   ("x", "offsets", "masks", "weight", "bias"), gk, gp)},
               "fwd_ms": time_ms(torch, lambda: D.deform_conv2d(*inputs, G, 3), 5),
               "fwd_bwd_ms": bwd_ms, "fwd_bwd_ms_with_atomics": atomics_ms,
               "bwd_repeat_bit_identical": same,
               "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
               "plain_fwd_bwd_ms": time_ms(
                   torch, lambda: grads_of(lambda *t: D.deform_plain(*t, G, 3), inputs, g),
                   5, 1)}
        emit(row)
        rows.append(row)
        del x, masks, weight, bias, off, g, inputs, grads, ok, op, gk, gp
        torch.cuda.empty_cache()
        if not (row["fwd_max_abs_err"] <= 2e-5 and max(row["grad_rel_err"].values()) <= 1e-5
                and same):
            raise AssertionError(f"deform at a training shape disagrees: {row}")
    return rows


def reference_check_train(torch) -> dict:
    """One LHBDC(N=128) 'ste' training step at 1x128x128 on the card (warp
    kernel forward, backward through autograd, cuDNN float32 with TF32 off)
    against the same step on the CPU (plain versions), from the same
    parameters: the loss within 1e-4 relative; each parameter's gradient
    error relative to its max |g|, the median within 1e-4 and the worst
    within 5e-2 (float32 rounding on either device can flip a sample
    point's bilinear cell or a latent's rounding bin, which moves the
    gradients upstream of it by ~1e-3 to ~1e-2 of their max; the median
    measures everything else); and one full step (optimizer included) that
    moves the weights and every quantile."""
    from tpuvc_torch.models.lhbdc import LHBDC
    from tpuvc_torch.train.trainer import make_lhbdc_step, make_optimizer

    model = LHBDC(N=128, generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    base = torch.rand((1, 1, 128, 128, 3), generator=g)
    drift = 0.05 * torch.randn((1, 1, 128, 128, 3), generator=g)
    batch = torch.clamp(torch.cat([base - drift, base, base + drift], dim=1), 0, 1)
    results = {}
    for dev in ("cpu", "cuda"):
        model.to(dev)
        params = dict(model.named_parameters())
        step = make_lhbdc_step(model, make_optimizer(), alpha=1626.0, mode="ste")
        loss, _ = step.loss_fn(batch.to(dev), 0)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        results[dev] = (float(loss.detach()), {
            n: gr.cpu() if gr is not None else torch.zeros_like(p.detach().cpu())
            for (n, p), gr in zip(params.items(), grads)})
    (cpu_loss, cpu_g), (card_loss, card_g) = results["cpu"], results["cuda"]
    errs = {n: _grad_err(torch, card_g[n], cpu_g[n]) for n in cpu_g}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    tx = make_optimizer()
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    reset_launches()
    _, _, metrics = make_lhbdc_step(model, tx, alpha=1626.0, mode="ste")(
        params, tx.init(params), batch.cuda(), 0)
    launches = read_launches()
    moved = sum(not torch.equal(before[n], p.detach()) for n, p in params.items())
    quantiles = [n for n in params if n.endswith(".quantiles")]
    row = {"phase": "reference_check_train", "model": "LHBDC(N=128) seeded", "mode": "ste",
           "shape": [1, 3, 128, 128, 3], "loss_card": card_loss, "loss_cpu": cpu_loss,
           "loss_rel_err": abs(card_loss - cpu_loss) / abs(cpu_loss),
           "grad_rel_err_max": worst[0][1], "grad_rel_err_worst": dict(worst),
           "grad_rel_err_median": sorted(errs.values())[len(errs) // 2],
           "tensors": len(errs), "step_launches": launches,
           "tensors_moved": moved, "step_loss": float(metrics["loss"])}
    row["quantiles_moved"] = all(not torch.equal(before[n], params[n].detach())
                                 for n in quantiles)
    emit(row)
    model.cpu()
    if not (row["loss_rel_err"] <= 1e-4 and row["grad_rel_err_median"] <= 1e-4
            and row["grad_rel_err_max"] <= 5e-2 and moved > 0 and row["quantiles_moved"]
            and launches["warp"] > 0):
        raise AssertionError(f"training step card vs CPU disagrees: {row}")
    return row


# The train CLI per family at full width on synthetic data (no dataset is
# in the tree): batch 8, 256x256 crops, tpuvc's defaults otherwise; 2 steps
# a family, stage 2 of the recursive families from the second (FlowGuidedB
# 6 steps, LHBDC and DMC 6, the others 4, until the smoke's time limit
# asked for the cuts), FlowGuidedB with one BD-rate validation. Each runs
# twice with the same arguments: train_determinism compares the two.
TRAIN_RUNS = [
    ("flowguided_b", ["total_steps=2", "val_every=2"]),
    ("lhbdc", ["total_steps=2"]),
    ("dmc", ["n_pframes=2", "total_steps=2"]),
    ("deform_b", ["total_steps=2"]),
    ("flexrate", ["total_steps=2"]),
    ("elic", ["total_steps=2"]),
]
TRAIN_KERNELS = {"lhbdc": ["warp"], "flowguided_b": ["warp", "deform"],
                 "deform_b": ["deform"], "flexrate": ["warp"], "dmc": ["warp"], "elic": []}

# Run in a fresh interpreter by train_cli, from the repository root: the
# train CLI's main on each argument list of the JSON list argv[1], one after
# the other, with a LaunchLog in front of each kernel library; prints a line
# {"wall_s", "summary"} a run, then the launched shapes as the last line.
TRAIN_IN_A_NEW_PROCESS = """
import json, sys, time
import chip_smoke
from tpuvc_torch.cli import train
logged = chip_smoke.log_launches()
for args in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    summary = train.main(args)
    print(json.dumps({"wall_s": time.perf_counter() - t0, "summary": summary}), flush=True)
print(json.dumps({k: sorted(v) for k, v in logged.items()}))
"""


def train_cli(torch, logged: dict, tmp: str) -> list[dict]:
    """The train CLI's main for each of TRAIN_RUNS, twice in a row, all in
    one subprocess (TRAIN_IN_A_NEW_PROCESS; one process a family until the
    smoke's time limit asked for the processes' start-up), on the card, at
    full width: the first run's summary (it/s after the first step, frames
    trained per second, the last loss, rate and distortion, peak memory,
    kernel launches), then its ``latest.msgpack`` loaded strictly through
    ``params_from_jax`` into the family's model, and the main parameters
    and the quantiles both moved from the seeded initial weights; each row
    keeps the second run's summary and checkpoint directory for
    train_determinism. The kernel shapes the runs launched join ``logged``
    for path_shapes_check."""
    import math

    import numpy as np

    from tpuvc_torch.cli import train
    from tpuvc_torch.config import TrainConfig, apply_overrides
    from tpuvc_torch.train.trainer import make_optimizer
    from tpuvc_torch.utils.checkpoint import load_checkpoint
    from tpuvc_torch.utils.convert import params_from_jax, params_to_jax

    root = os.path.dirname(os.path.abspath(__file__))
    runs = [["--device", "cuda", f"model.family={family}", f"batch_size={TRAIN_B}",
             f"crop={TRAIN_CROP}", "stage2_start=1",
             f"checkpoint_dir={os.path.join(tmp, f'train_{family}{again}')}", *extra]
            for family, extra in TRAIN_RUNS for again in ("", "_again")]
    release_cache(torch)
    proc = subprocess.run([sys.executable, "-c", TRAIN_IN_A_NEW_PROCESS, json.dumps(runs)],
                          cwd=root, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"train CLI failed:\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    shapes = json.loads(lines[-1])
    for k in logged:
        logged[k].update(tuple(v) for v in shapes[k])
    done = [json.loads(line) for line in lines if line.startswith('{"wall_s"')]
    if len(done) != len(runs):
        raise AssertionError(f"train CLI: {len(done)} summaries for {len(runs)} runs")
    rows = []
    for (family, _), args, run, again in zip(TRAIN_RUNS, runs[::2], done[::2], done[1::2]):
        ck_dir = os.path.join(tmp, f"train_{family}")
        summary, wall_s = run["summary"], run["wall_s"]
        cfg = apply_overrides(TrainConfig(), [f"model.family={family}"])
        model, _, _ = train.build_family(cfg, make_optimizer(), np.random.default_rng(0))
        init = params_to_jax(model)
        ck = load_checkpoint(os.path.join(ck_dir, "latest.msgpack"))
        model.load_state_dict(params_from_jax(ck["params"]), strict=True)
        moved = {"main": 0, "quantiles": 0}
        for path, v in _leaves(ck["params"]):
            if not np.array_equal(v, _get(init, path)):
                moved["quantiles" if path[-1] == "quantiles" else "main"] += 1
        row = {"phase": "train_cli", "path": f"train_{family}", "family": family,
               "args": args, "wall_s": wall_s, **summary, "checkpoint_step": int(ck["step"]),
               "tensors_moved": moved, "best_msgpack": os.path.exists(
                   os.path.join(ck_dir, "best.msgpack"))}
        emit(row)
        rows.append({**row, "again": again["summary"], "checkpoint_dirs": [
            ck_dir, os.path.join(tmp, f"train_{family}_again")]})
        m = summary["metrics"]
        if not all(math.isfinite(m[k]) for k in ("loss", "rate", "mse", "aux")):
            raise AssertionError(f"train {family}: a metric is not finite: {m}")
        if not (moved["main"] > 0 and moved["quantiles"] > 0):
            raise AssertionError(f"train {family}: weights did not move: {moved}")
        for k in TRAIN_KERNELS[family]:
            if summary["launches"][k] == 0:
                raise AssertionError(f"train {family} launched no {k} kernel")
        # best.msgpack is written when the validation's BD-rate against the
        # published anchor improves; seeded weights code at ~6 dB, far below
        # the anchor's 36-39 dB, so that BD-rate extrapolates to +-100% or
        # inf/NaN by float noise, and the file is reported, not required.
        if family == "flowguided_b" and summary["validations"] < 1:
            raise AssertionError("train flowguided_b ran no BD-rate validation")
    return rows


def train_determinism(rows: list[dict]) -> list[dict]:
    """Each family's two train CLI runs of train_cli (one seed, one batch
    stream, the same arguments, under the CLI's deterministic_training):
    their parameters' sha256 (the summary's ``params_sha256``) must be
    equal; where they are not, how many tensors of the two checkpoints
    differ."""
    import numpy as np

    from tpuvc_torch.utils.checkpoint import load_checkpoint

    out, bad = [], []
    for r in rows:
        digests = [r["params_sha256"], r["again"]["params_sha256"]]
        row = {"phase": "train_determinism", "family": r["family"],
               "steps": r["steps"], "args": r["args"], "params_sha256": digests,
               "bit_identical": digests[0] == digests[1],
               "last_loss": [r["metrics"]["loss"], r["again"]["metrics"]["loss"]]}
        if not row["bit_identical"]:
            a, b = (dict(_leaves(load_checkpoint(os.path.join(d, "latest.msgpack"))["params"]))
                    for d in r["checkpoint_dirs"])
            differing = sorted(".".join(k) for k in a if not np.array_equal(a[k], b[k]))
            row.update(tensors=len(a), tensors_differing=len(differing),
                       differing=differing[:8])
            bad.append(r["family"])
        emit(row)
        out.append(row)
    if bad:
        raise AssertionError(f"train_determinism: two runs differ for {bad}")
    return out


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# Run in a fresh interpreter by trained_checkpoint_codes: decode_b's main on
# the other arguments, printing the sha256 of the float32 reconstruction.
DECODE_B_IN_A_NEW_PROCESS = """
import hashlib, json, sys
from tpuvc_torch.cli import decode_b
x_hat = decode_b.main(sys.argv[1:])
print(json.dumps({"sha256": hashlib.sha256(x_hat.cpu().numpy().tobytes()).hexdigest()}))
"""


def trained_checkpoint_codes(torch, tmp: str) -> dict:
    """The LHBDC checkpoint train_cli wrote, saved as
    ``compression_1626.msgpack``, codes a 1088x1920 B-frame through
    ``encode_b --weights`` (in this process, launches counted), and
    ``decode_b`` decodes the stream in a fresh process: its reconstruction
    must equal the encoder's bit for bit."""
    import hashlib
    import io
    import shutil

    from tpuvc_torch.cli import encode_b
    from tpuvc_torch.data.frames import save_png
    from tpuvc_torch.data.uvg import SyntheticSequence

    h, w = FRAME
    wdir = os.path.join(tmp, "trained_weights")
    os.makedirs(wdir, exist_ok=True)
    shutil.copy(os.path.join(tmp, "train_lhbdc", "latest.msgpack"),
                os.path.join(wdir, "compression_1626.msgpack"))
    seq = SyntheticSequence(n_frames=3, h=h, w=w, seed=3)
    names = [os.path.join(tmp, f"tc_{k}.png") for k in ("ref_1", "current", "ref_2")]
    for i, name in enumerate(names):
        save_png(name, seq.u8(i)[0, :h, :w])
    bin_path = os.path.join(tmp, "trained.bin")
    common = ["--family", "lhbdc", "--ref_1", names[0], "--ref_2", names[2],
              "--weights", wdir, "--device", "cuda", "--bin", bin_path]
    release_cache(torch)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        bits, x_hat = encode_b.main(common + ["--current", names[1], "--l", "1626"])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    launches = read_launches()
    enc_sha = hashlib.sha256(x_hat.cpu().numpy().tobytes()).hexdigest()
    finite = bool(torch.isfinite(x_hat).all())
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", DECODE_B_IN_A_NEW_PROCESS, *common,
         "--out", os.path.join(tmp, "trained_dec.png")],
        cwd=root, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"decode_b of the trained checkpoint failed:\n{proc.stderr[-4000:]}")
    dec_sha = json.loads(proc.stdout.strip().splitlines()[-1])["sha256"]
    from tpuvc_torch.eval.metrics import psnr_uint8_np

    psnr = psnr_uint8_np(seq.u8(1)[0, :h, :w], x_hat[0, :h, :w].clamp(0, 1).cpu().numpy())
    row = {"phase": "trained_checkpoint_codes", "weights": "train_cli's LHBDC latest.msgpack",
           "frame": [h, w], "bytes": bits.num_bytes, "bpp": 8 * bits.num_bytes / (h * w),
           "psnr_db": psnr, "encode_s": enc_s, "launches": launches,
           "decode_bit_exact": enc_sha == dec_sha, "finite": finite}
    emit(row)
    if not (row["decode_bit_exact"] and finite and launches["warp"] > 0):
        raise AssertionError(f"the trained checkpoint does not code bit-exact: {row}")
    return row


# The reference checkpoints imported_checkpoint_codes builds at full width
# (tests/torch_reference_sd.py): (importer family, its widths, where
# the port's CLIs read the converted file, the port model it loads into,
# built by _port_model).
IMPORTED = [
    ("lhbdc", {"n": 128}, "compression_1626.msgpack", "LHBDC(N=128)"),
    ("flexrate", {"n": 128}, "flexrate.msgpack", "BidirFlowRef(N=128)"),
    ("elic", {}, os.path.join("elic", "level_0", "latest.msgpack"), "ELIC()"),
    ("deform_b", {}, "deform_b.msgpack", "DeformB()"),
    ("flowguided", {}, "flowguided_b.msgpack", "FlowGuidedB()"),
]
# The imported families that code a B-frame: (encode_b --family, its
# arguments, the kernels it must launch, its name in launches_by_path).
IMPORTED_CODES = [
    ("lhbdc", ["--l", "1626"], ["warp"], "imported_lhbdc_encode_b"),
    ("flowguided_b", ["--s", "1.0"], ["warp", "deform"], "imported_flowguided_encode_b"),
]


def _port_model(family: str):
    """The port model an imported family's checkpoint loads into."""
    if family == "lhbdc":
        from tpuvc_torch.models.lhbdc import LHBDC

        return LHBDC(N=128)
    if family == "flexrate":
        from tpuvc_torch.models.flexrate import BidirFlowRef

        return BidirFlowRef(N=128)
    if family == "elic":
        from tpuvc_torch.models.elic import ELIC

        return ELIC()
    if family == "deform_b":
        from tpuvc_torch.models.deform_b import DeformB

        return DeformB()
    from tpuvc_torch.models.flowguided_b import FlowGuidedB

    return FlowGuidedB()


def imported_checkpoint_codes(torch, tmp: str) -> dict:
    """Reference (PyTorch) checkpoints of every importer family, built at
    full width from a numpy seed (tests/torch_reference_sd.py) and saved
    with torch.save (LHBDC in its trainer's {"state_dict": ...} wrapper), go
    through ``python -m tpuvc_torch.cli.import_torch`` (one subprocess each,
    all started together); each result must load strictly into its port
    model, with no unmapped key. Then the imported LHBDC and FlowGuidedB each
    code one 1088x1920 B-frame through ``encode_b --weights`` (in this
    process, launches counted), and ``decode_b`` decodes each stream in a
    fresh process: its reconstruction must equal the encoder's bit for bit.
    Returns {"imports": rows, "codes": {family: row}, "weights": dir}."""
    import hashlib
    import io

    import numpy as np

    sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_reference_sd as R

    from tpuvc_torch.cli import encode_b
    from tpuvc_torch.data.frames import save_png
    from tpuvc_torch.data.uvg import SyntheticSequence
    from tpuvc_torch.eval.metrics import psnr_uint8_np
    from tpuvc_torch.utils.checkpoint import load_checkpoint
    from tpuvc_torch.utils.convert import params_from_jax

    root = os.path.dirname(os.path.abspath(__file__))
    wdir = os.path.join(tmp, "imported_weights")
    os.makedirs(os.path.join(wdir, "elic", "level_0"), exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for i, (family, widths, target, _) in enumerate(IMPORTED):
        pth = os.path.join(tmp, f"{family}.pth")
        R.save_pth(pth, R.STATE_DICTS[family](np.random.default_rng(20 + i), **widths),
                   wrap=family == "lhbdc")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpuvc_torch.cli.import_torch", "--input", pth,
             "--output", os.path.join(wdir, target), "--family", family],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    imports = []
    for (family, widths, target, desc), proc in zip(IMPORTED, procs):
        out, err = proc.communicate(timeout=180)
        if proc.returncode != 0 or "WARNING" in out:
            raise AssertionError(f"import_torch --family {family} failed:\n{out}{err[-4000:]}")
        model = _port_model(family)
        model.load_state_dict(params_from_jax(load_checkpoint(os.path.join(wdir, target))),
                              strict=True)
        imports.append({"family": family, "model": desc, "cli": out.strip().splitlines()[0],
                        "parameters": sum(p.numel() for p in model.parameters())})
        del model
    row = {"phase": "imported_checkpoint_codes", "imports": imports,
           "import_and_load_s": time.perf_counter() - t0}
    emit(row)

    h, w = FRAME
    seq = SyntheticSequence(n_frames=3, h=h, w=w, seed=5)
    names = [os.path.join(tmp, f"ic_{k}.png") for k in ("ref_1", "current", "ref_2")]
    for i, name in enumerate(names):
        save_png(name, seq.u8(i)[0, :h, :w])
    codes, decoders = {}, []
    for family, args, kernels, path in IMPORTED_CODES:
        bin_path = os.path.join(tmp, f"imported_{family}.bin")
        common = ["--family", family, "--ref_1", names[0], "--ref_2", names[2],
                  "--weights", wdir, "--device", "cuda", "--bin", bin_path]
        release_cache(torch)
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            bits, x_hat = encode_b.main(common + ["--current", names[1]] + args)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        launches = read_launches()
        codes[family] = {
            "phase": "imported_checkpoint_codes", "family": family, "path": path,
            "frame": [h, w],
            "bytes": bits.num_bytes, "bpp": 8 * bits.num_bytes / (h * w),
            "psnr_db": psnr_uint8_np(seq.u8(1)[0, :h, :w],
                                     x_hat[0, :h, :w].clamp(0, 1).cpu().numpy()),
            "encode_s": enc_s, "launches": launches,
            "finite": bool(torch.isfinite(x_hat).all()),
            "enc_sha": hashlib.sha256(x_hat.cpu().numpy().tobytes()).hexdigest(),
        }
        del x_hat
        decoders.append((family, kernels, subprocess.Popen(
            [sys.executable, "-c", DECODE_B_IN_A_NEW_PROCESS, *common,
             "--out", os.path.join(tmp, f"imported_{family}.png")],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for family, kernels, proc in decoders:
        out, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"decode_b of the imported {family} failed:\n{err[-4000:]}")
        code = codes[family]
        code["decode_bit_exact"] = json.loads(out.strip().splitlines()[-1])["sha256"] == \
            code.pop("enc_sha")
        emit(code)
        if not (code["decode_bit_exact"] and code["finite"]):
            raise AssertionError(f"the imported {family} does not code bit-exact: {code}")
        for k in kernels:
            if code["launches"][k] == 0:
                raise AssertionError(f"the imported {family} launched no {k} kernel")
    return {"imports": imports, "codes": codes, "weights": wdir}


def image_eval_cli(torch, intra_weights: str, tmp: str) -> dict:
    """The still-image eval CLI (tpuvc_torch.cli.test_image) on the card:
    three synthetic Kodak-size (768x512) images a level at levels 0 and 1,
    level 0 from the ELIC weights imported_checkpoint_codes converted
    (``{intra_weights}/level_0/latest.msgpack``), level 1 from the seeded
    weights, in float32 (the CLI's default) and again in bfloat16 (reported
    beside it). Then the RD-eval CLI with ``write_plots=true``: where
    matplotlib is missing it must exit, before any work, naming it;
    where it is installed it must write its figures."""
    import importlib.util
    import io
    import math

    from tpuvc_torch.cli import test_image

    release_cache(torch)
    torch.cuda.reset_peak_memory_stats()
    argv = ["--device", "cuda", "dataset.name=synthetic", "dataset.height=512",
            "dataset.width=768", "levels=(0,1)", f"intra_weights={intra_weights}",
            f"output_dir={os.path.join(tmp, 'image_eval')}"]
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = test_image.main(argv)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with contextlib.redirect_stdout(io.StringIO()):
        bf16 = test_image.main(argv + ["compute_dtype=bfloat16"])

    def after_first(o):
        return o["images"] / o["levels"][1]["seconds"]

    levels = out["levels"]
    row = {"phase": "image_eval_cli", "argv": argv, "images_per_level": out["images"],
           "per_level": levels,
           "first_level_images_per_s": out["images"] / levels[0]["seconds"],
           "images_per_s_after_first_level": after_first(out), "peak_mem_gib": peak,
           "loaded_level_0": "level 0: loaded" in printed.getvalue(),
           "bfloat16": {"per_level": bf16["levels"],
                        "images_per_s_after_first_level": after_first(bf16)}}
    plots_dir = os.path.join(tmp, "plots")
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    plot_cmd = [sys.executable, "-m", "tpuvc_torch.cli.test", "--device", "cuda",
                "write_plots=true", f"output_dir={plots_dir}"]
    if has_mpl:
        plot_cmd += ["dataset.name=synthetic", 'dataset.sequences={"synth": 5}',
                     "dataset.gop=4", "dataset.width=128", "dataset.height=128",
                     "model.family=lhbdc", "levels=(0,)"]
    proc = subprocess.run(plot_cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300)
    row["write_plots"] = {"matplotlib": has_mpl, "returncode": proc.returncode,
                          "message": (proc.stderr.strip().splitlines() or [""])[-1]}
    emit(row)
    finite = all(math.isfinite(v["psnr"]) and math.isfinite(v["bpp"]) and v["bpp"] > 0
                 for v in levels.values())
    if sorted(levels) != [0, 1] or not finite or not row["loaded_level_0"]:
        raise AssertionError(f"image_eval_cli: bad rows: {row}")
    if has_mpl:
        if proc.returncode != 0 or not os.path.exists(os.path.join(plots_dir, "rd_curve.png")):
            raise AssertionError(f"write_plots drew no figures: {proc.stderr[-4000:]}")
    elif proc.returncode == 0 or "matplotlib" not in row["write_plots"]["message"]:
        raise AssertionError(f"write_plots without matplotlib did not exit naming it: {row}")
    return row


# -- the mesh paths: one process per device, launched by torchrun ----------
#
# On a host with one card, two ranks share it over gloo (NCCL refuses two
# ranks on one GPU): they drive the sharded code through both kernels at
# each rank's share of the level batches. nccl_world1 checks NCCL's
# collectives in a one-rank group on the card.

MESH_ARGS = ["--mesh", "2", "--dist_backend", "gloo"]
# (path, family, encode_v arguments) at batch cap 2, one GOP a window: the
# level batches are 1 (coded whole on each rank) and 2 (split), so each
# rank codes every level at batch 1. The mesh-1 reference run takes the
# same arguments at cap 1: the ranks' batch shapes, one process. (A mesh-1
# run at cap 2 codes other batch shapes, and on the card a level batch's
# floats depend on its batch size: level_batch_shape_dependence.)
MESH_SEQUENCE_RUNS = [  # 9 frames, one GOP-8 (17, one GOP-16, until the smoke's time limit)
    ("lhbdc", "lhbdc", [
        "--family", "lhbdc", "--synthetic", "9", "--gop", "8", "--level_batched",
        "--max_batch", "2", "--compute_dtype", "bfloat16", "--l", "845"]),
    ("flowguided_b", "flowguided_b", [
        "--family", "flowguided_b", "--synthetic", "9", "--gop", "8", "--level_batched",
        "--max_batch", "2", "--compute_dtype", "bfloat16", "--s", "1.0"]),
]
MESH_RECON_BAR = 1e-4  # mesh 2 against mesh 1 at the ranks' batch shapes


def level_batch_shape_dependence(torch) -> list[dict]:
    """How far one level batch's reconstructions on the card move with its
    batch size alone: LHBDC(N=128) and FlowGuidedB (full width, heads
    seeded) code the same two 1088x1920 B-frames as one batch of 2 and as
    two batches of 1, in float32, in this one process.
    Reported, not a pass condition: cuDNN's algorithm follows the batch
    size, and a latent that then rounds the other way moves its region of
    the frame (the reason a stream records the mesh it was coded over)."""
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.data.uvg import SyntheticSequence, device_frame
    from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder
    from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder
    from tpuvc_torch.ops.precision import policy_from_name

    src = SyntheticSequence(n_frames=GOP + 1, h=FRAME[0], w=FRAME[1])
    x = {i: device_frame(src.u8(i), "cuda") for i in (0, 4, 8, 12, 16)}
    xb, xa = torch.cat([x[0], x[8]]), torch.cat([x[8], x[16]])
    xc = torch.cat([x[4], x[12]])
    lhbdc = LHBDCCoder(LHBDC(N=128, generator=torch.Generator().manual_seed(0)))
    v4 = FlowGuidedBCoder(v4_model(torch))
    coders = {
        "lhbdc": lambda b, c, a: lhbdc.encode_level_batch(b, c, a, rate_id=845),
        "flowguided_b": lambda b, c, a: v4.encode_level_batch(b, a, c, s=1.0, scale1=0.5,
                                                             scale2=-0.5),
    }
    rows = []
    try:
        with policy_from_name("float32"):
            for family, code in coders.items():
                bits2, x2 = code(xb, xc, xa)
                ones = [code(xb[i:i + 1], xc[i:i + 1], xa[i:i + 1]) for i in range(2)]
                d = (torch.clamp(x2, 0, 1) - torch.clamp(torch.cat([o[1] for o in ones]),
                                                         0, 1)).abs()
                rows.append({
                    "phase": "level_batch_shape_dependence", "family": family,
                    "compute_dtype": "float32", "frame": list(FRAME),
                    "batch_2_vs_two_batches_of_1_max_abs": float(d.max()),
                    "share_above_1e-4": float((d > 1e-4).float().mean()),
                    "streams_equal": [a.serialize() == o[0][0].serialize()
                                      for a, o in zip(bits2, ones)]})
                emit(rows[-1])
    finally:
        parallel.shutdown()
    return rows


# Run by torchrun in each rank, from the repository root: for each job of
# the JSON list in the third argument ({"tag", "ref", "argv"}), the main of
# the sequence CLI named by the first argument on the job's arguments, in
# the group this script joins first (gloo, so that two ranks can share a
# card), with the zero-initialised heads seeded and a LaunchLog in front of
# each kernel library; saves this rank's launches, seconds, peak memory,
# per-frame sha256, printed lines and launched shapes as
# OUT/TAG_CLI_RANK.json. Where a job names a "ref" file, rank 0 also writes
# the largest difference of its frames from the frames saved there.
MESH_CLI_IN_RANKS = """
import contextlib, hashlib, importlib, io, json, os, sys, time
import torch
import torch.distributed as dist
import chip_smoke
from tpuvc_torch.parallel.mesh import make_mesh
name, out_dir, jobs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
cli = importlib.import_module("tpuvc_torch.cli." + name)
device = jobs[0]["argv"][jobs[0]["argv"].index("--device") + 1]
mesh = make_mesh(backend="gloo", device=device)
cuda = mesh.device.type == "cuda"
logged = chip_smoke.log_launches() if cuda else {"warp": set(), "deform": set(),
                                                 "epilogue": set()}
for job in jobs:
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for k in logged:
        logged[k].clear()
    spread, log = {}, io.StringIO()
    with chip_smoke.cli_heads_seeded(spread):
        chip_smoke.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rec = cli.main(job["argv"])
        main_s = time.perf_counter() - t0
    out = {"rank": mesh.rank, "main_s": main_s, "launches": chip_smoke.read_launches(),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
           "sha256": {str(i): hashlib.sha256(t.numpy().tobytes()).hexdigest()
                      for i, t in rec.items()},
           "log": log.getvalue(), "spread": spread,
           "shapes": {k: sorted(v) for k, v in logged.items()}}
    if job["ref"] and mesh.rank == 0:
        ref = torch.load(job["ref"])
        out["max_abs_diff_vs_mesh1"] = max(float((rec[i] - ref[i]).abs().max()) for i in ref)
    with open(os.path.join(out_dir, f"{job['tag']}_{name}_{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    del rec
dist.destroy_process_group()
"""


def launch_ranks(n: int, script: str, args: list, timeout: int) -> str:
    """``python -m torch.distributed.run --standalone --nproc_per_node n``
    running ``python -c script args`` (after ``--``, so that torchrun's
    parser takes none of them); returns its output. A failing rank
    fails the launch; on a timeout or any other error the launcher gets
    SIGTERM (it stops its ranks) and then SIGKILL."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(n), "--no-python", "--", sys.executable, "-c", script, *args],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except BaseException:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        finally:
            proc.kill()
            proc.wait()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"a {n}-rank launch exited {proc.returncode}:\n{out[-6000:]}")
    return out


def _rank_rows(out_dir: str, name: str, n: int) -> list[dict]:
    rows = []
    for r in range(n):
        with open(os.path.join(out_dir, f"{name}_{r}.json")) as f:
            rows.append(json.load(f))
    return rows


def mesh_sequence_cli(torch, logged: dict, tmp: str, device: str = "cuda") -> list[dict]:
    """For each of MESH_SEQUENCE_RUNS: encode_v in this process at mesh 1
    and batch cap 1 (the reference frames, at the ranks' batch shapes);
    then ``encode_v --mesh 2`` for every run in one launch of two gloo
    ranks sharing the card, and ``decode_v`` on each file in a fresh 2-rank
    launch (MESH_CLI_IN_RANKS). The header must read mesh 2, every rank's
    decoded frames equal the encoder's by sha256, the frames lie within
    MESH_RECON_BAR of the mesh-1 run's, and every rank launch each kernel
    its family uses; each rank's launched shapes join ``logged``."""
    import io

    from tpuvc_torch.cli import encode_v
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import VSequenceBitstream

    size = ["--width", str(FRAME[1]), "--height", str(FRAME[0])]
    model = ["--init", "random", "--device", device]
    out_dir = os.path.join(tmp, "mesh_ranks")
    os.makedirs(out_dir)
    enc_jobs, dec_jobs = [], []
    for path, family, argv in MESH_SEQUENCE_RUNS:
        ref_path = os.path.join(tmp, f"{path}_mesh1.pt")
        cap = argv.index("--max_batch")
        ref_argv = argv[:cap] + ["--max_batch", "1"] + argv[cap + 2:]
        try:
            with cli_heads_seeded(), contextlib.redirect_stdout(io.StringIO()):
                ref = encode_v.main(ref_argv + size + model + ["--bin", ref_path + ".tpvb"])
        finally:
            parallel.shutdown()
        torch.save(ref, ref_path)
        del ref
        bin_path = os.path.join(tmp, f"{path}_mesh2.tpvb")
        enc_jobs.append({"tag": path, "ref": ref_path,
                         "argv": argv + size + model + MESH_ARGS + ["--bin", bin_path]})
        dec_jobs.append({"tag": path, "ref": None, "argv": [
            "--bin", bin_path, "--out_dir", os.path.join(tmp, f"{path}_png"), *model,
            "--dist_backend", "gloo"]})
    if device == "cuda":
        release_cache(torch)
    launch_ranks(2, MESH_CLI_IN_RANKS, ["encode_v", out_dir, json.dumps(enc_jobs)], 360)
    launch_ranks(2, MESH_CLI_IN_RANKS, ["decode_v", out_dir, json.dumps(dec_jobs)], 360)
    rows = []
    for (path, family, argv), job in zip(MESH_SEQUENCE_RUNS, enc_jobs):
        enc = _rank_rows(out_dir, f"{path}_encode_v", 2)
        dec = _rank_rows(out_dir, f"{path}_decode_v", 2)
        with open(job["argv"][-1], "rb") as f:
            blob = f.read()
        seq = VSequenceBitstream.deserialize(blob)
        n, (h, w) = seq.n_frames, FRAME
        enc_s, dec_s = cli_seconds(enc[0]["log"], "wrote"), cli_seconds(dec[0]["log"], "decoded")
        bit_exact = all(r["sha256"] == enc[0]["sha256"] for r in enc + dec)
        for r in enc + dec:
            for k in logged:
                logged[k].update(tuple(v) for v in r["shapes"][k])
        row = {
            "phase": "mesh_sequence_cli", "path": path, "family": family,
            "encode_argv": argv + MESH_ARGS, "frame": [h, w], "frames": n,
            "mesh": seq.mesh, "ranks": 2, "dist_backend": "gloo", "ranks_share_one_card": True,
            "max_batch": seq.max_batch, "window_gops": seq.window_gops,
            "compute_dtype": "bfloat16" if seq.dtype == 1 else "float32",
            "encode_s": enc_s, "encode_fps": n / enc_s, "decode_s": dec_s,
            "decode_fps": n / dec_s, "bytes": len(blob), "bpp": 8 * len(blob) / (n * h * w),
            "decode_bit_exact": bit_exact, "decoder": "separate 2-rank launch",
            "max_abs_diff_vs_mesh1": enc[0]["max_abs_diff_vs_mesh1"],
            "mesh1_reference": "encode_v at --max_batch 1 (each rank's batch shapes)",
            "peak_mem_gib_by_rank": {"encode": [r["peak_mem_gib"] for r in enc],
                                     "decode": [r["peak_mem_gib"] for r in dec]},
            "launches_by_rank": {"encode": [r["launches"] for r in enc],
                                 "decode": [r["launches"] for r in dec]},
        }
        if family in SEEDED_FAMILIES:
            row["flow_offset_spread_rank0"] = enc[0]["spread"]
        emit(row)
        rows.append(row)
        if seq.mesh != 2 or seq.mode != 1:
            raise AssertionError(f"mesh_sequence_cli {path}: header mesh {seq.mesh}, mode {seq.mode}")
        if not bit_exact:
            raise AssertionError(f"mesh_sequence_cli {path}: a rank's frames differ")
        if not row["max_abs_diff_vs_mesh1"] <= MESH_RECON_BAR:
            raise AssertionError(f"mesh_sequence_cli {path}: mesh 2 differs from mesh 1 by "
                                 f"{row['max_abs_diff_vs_mesh1']}")
        for r in enc + dec:
            if family in SEEDED_FAMILIES:
                check_spread(r["spread"], f"mesh_sequence_cli {path} rank {r['rank']}", family)
            for k in FAMILY_KERNELS[family]:
                if device == "cuda" and r["launches"][k] == 0:
                    raise AssertionError(f"mesh_sequence_cli {path}: rank {r['rank']} "
                                         f"launched no {k} kernel")
    return rows


MESH_TRAIN_STEPS = 2  # 4 until the smoke's time limit asked for the cut

# Run by torchrun in each rank: joins a gloo group on the card, holds one
# data-parallel LHBDC(N=128) step's averaged gradients against the same
# step in one process (mesh_step0_gradients), then runs the train CLI on the
# arguments after the first, with the launch counts set to 0 just before;
# saves this rank's results as OUT/train_RANK.json.
MESH_TRAIN_IN_RANKS = """
import json, os, sys, time
import torch
import torch.distributed as dist
import chip_smoke
from tpuvc_torch.cli import train
from tpuvc_torch.parallel.mesh import make_mesh
out_dir, argv = sys.argv[1], sys.argv[2:]
device = argv[argv.index("--device") + 1]
mesh = make_mesh(backend="gloo", device=device)
cuda = mesh.device.type == "cuda"
logged = chip_smoke.log_launches() if cuda else {"warp": set(), "deform": set(),
                                                 "epilogue": set()}
kv = dict(a.split("=", 1) for a in argv if "=" in a and not a.startswith("--"))
out = {"rank": mesh.rank, "step0": chip_smoke.mesh_step0_gradients(
    torch, mesh, int(kv["batch_size"]), int(kv["crop"]), int(kv.get("model.N", 128)))}
if cuda:
    torch.cuda.reset_peak_memory_stats()
chip_smoke.reset_launches()
out["summary"] = train.main(argv)
out["launches"] = chip_smoke.read_launches()
out["shapes"] = {k: sorted(v) for k, v in logged.items()}
with open(os.path.join(out_dir, f"train_{mesh.rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def mesh_step0_gradients(torch, mesh, batch_size: int, crop: int, n: int) -> dict:
    """One data-parallel LHBDC(N=n) 'noise' step over ``mesh`` on the train
    CLI's first global batch (``batch_size`` windows of ``crop`` px), each
    rank on its rows: the gradients the optimizer gets; on rank 0, each
    tensor's error against the same step in one process on the whole
    batch, relative to its max |g|."""
    from tpuvc_torch.data.vimeo import SyntheticSeptuplets, make_batch_iterator
    from tpuvc_torch.models.lhbdc import LHBDC
    from tpuvc_torch.ops.precision import set_deterministic
    from tpuvc_torch.parallel.mesh import shard_batch
    from tpuvc_torch.train.trainer import data_parallel, make_lhbdc_step, make_optimizer

    if mesh.device.type == "cuda":
        set_deterministic()
    batch = next(make_batch_iterator(SyntheticSeptuplets(n=256, size=crop + 32), batch_size,
                                     crop, seed=0, raw_uint8=True))
    batch = torch.from_numpy(batch)

    def step_grads(rows, ranks):
        model = LHBDC(N=n, generator=torch.Generator().manual_seed(0)).to(mesh.device)
        tx, got = make_optimizer(), {}
        update = tx.update

        def keep(grads, state, params=None, value=None):
            got.update({k: g.detach().cpu() for k, g in grads.items()}, loss=float(value))
            return update(grads, state, params, value=value)

        tx.update = keep
        params = dict(model.named_parameters())
        with ranks:
            make_lhbdc_step(model, tx, alpha=1626.0)(
                params, tx.init(params), rows.to(mesh.device).float() / 255.0, (1, 0))
        return got

    got = step_grads(shard_batch(mesh, batch), data_parallel(mesh, batch.shape[0]))
    row = {"model": f"LHBDC(N={n}) seeded", "batch": batch_size, "crop": crop, "mode": "noise",
           "rows_per_rank": batch_size // mesh.size, "loss_mesh": got.pop("loss")}
    if mesh.rank == 0:
        ref = step_grads(batch, contextlib.nullcontext())
        row["loss_one_process"] = ref.pop("loss")
        errs = sorted(_grad_err(torch, got[k], ref[k]) for k in ref)
        row.update(tensors=len(errs), grad_rel_err_max=errs[-1],
                   grad_rel_err_median=errs[len(errs) // 2])
    return row


def mesh_train_cli(torch, logged: dict, tmp: str, device: str = "cuda",
                   extra: tuple = ()) -> dict:
    """The train CLI for LHBDC(N=128) in two gloo ranks sharing the card
    (MESH_TRAIN_IN_RANKS): global batch TRAIN_B of TRAIN_CROP crops,
    MESH_TRAIN_STEPS steps, float32. The step-0 averaged gradients against
    a one-process step on the same batch under reference_check_train's bars
    (median <= 1e-4, worst <= 5e-2 of each tensor's max), and the ranks'
    parameters bit-identical after the last step (the CLI compares every
    tensor's sha256 across the ranks and fails otherwise)."""
    out_dir = os.path.join(tmp, "mesh_train")
    os.makedirs(out_dir)
    args = ["--device", device, "--dist_backend", "gloo", "model.family=lhbdc",
            f"batch_size={TRAIN_B}", f"crop={TRAIN_CROP}", f"total_steps={MESH_TRAIN_STEPS}",
            f"checkpoint_dir={os.path.join(tmp, 'mesh_train_ck')}", *extra]
    if device == "cuda":
        release_cache(torch)
    t0 = time.perf_counter()
    launch_ranks(2, MESH_TRAIN_IN_RANKS, [out_dir, *args], 300)
    wall_s = time.perf_counter() - t0
    ranks = _rank_rows(out_dir, "train", 2)
    for r in ranks:
        for k in logged:
            logged[k].update(tuple(v) for v in r["shapes"][k])
    s, step0 = ranks[0]["summary"], ranks[0]["step0"]
    digests = s["rank_params_sha256"]
    row = {"phase": "mesh_train_cli", "path": "mesh_train_lhbdc", "family": "lhbdc",
           "args": args, "ranks": 2, "dist_backend": "gloo", "ranks_share_one_card": True,
           "wall_s": wall_s, "steps": s["steps"], "steps_per_s_after_first":
           s["steps_per_s_after_first"], "frames_per_s_after_first":
           s["frames_per_s_after_first"], "first_step_s": s["first_step_s"],
           "metrics": s["metrics"], "skipped_nonfinite": s["skipped_nonfinite"],
           "params_bit_identical": len(digests) == 2 and len(set(digests)) == 1,
           "rank_params_sha256": digests, "step0": step0,
           "peak_mem_gib_rank0": s["peak_mem_gib"],
           "launches_by_rank": [r["launches"] for r in ranks]}
    emit(row)
    if not row["params_bit_identical"]:
        raise AssertionError(f"mesh_train_cli: the ranks' parameters differ: {digests}")
    if not (step0["grad_rel_err_median"] <= 1e-4 and step0["grad_rel_err_max"] <= 5e-2):
        raise AssertionError(f"mesh_train_cli: step-0 gradients over the mesh disagree: {step0}")
    if device == "cuda" and not all(r["launches"]["warp"] > 0 for r in ranks):
        raise AssertionError("mesh_train_cli: a rank launched no warp kernel")
    return row


# Run by torchrun in one rank: a one-rank NCCL group on the card; the
# port's collectives and torch.distributed's own on CUDA tensors.
NCCL_WORLD1_IN_RANKS = """
import json, sys
import torch
import torch.distributed as dist
from tpuvc_torch.parallel import mesh as M
mesh = M.make_mesh(backend="nccl")
x = torch.arange(12.0, device=mesh.device).reshape(6, 2)
y = x.clone()
dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
z = torch.zeros_like(x) if mesh.rank else x.clone()
dist.broadcast(z, src=0, group=mesh.group)
parts = [torch.empty_like(x)]
dist.all_gather(parts, x, group=mesh.group)
bf = x.to(torch.bfloat16) / 3
out = {"backend": mesh.backend, "device": str(mesh.device), "size": mesh.size,
       "all_reduce": torch.equal(y, x), "broadcast": torch.equal(z, x),
       "all_gather": torch.equal(parts[0], x),
       "all_reduce_mean": torch.equal(M.all_reduce_mean(mesh, x), x),
       "broadcast_": torch.equal(M.broadcast_(mesh, x.clone()), x),
       "all_gather_rows_bf16": torch.equal(M.all_gather_rows(mesh, bf), bf),
       "all_gather_objects": M.all_gather_objects(mesh, {"rank": mesh.rank}) == [{"rank": 0}],
       "shard_batch": torch.equal(M.shard_batch(mesh, x), x),
       "on_device": M.all_gather_rows(mesh, x).device == mesh.device}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def nccl_world1(tmp: str) -> dict:
    """NCCL_WORLD1_IN_RANKS in a one-rank torchrun launch: every check must
    hold, on cuda:0, over nccl."""
    path = os.path.join(tmp, "nccl_world1.json")
    launch_ranks(1, NCCL_WORLD1_IN_RANKS, [path], 180)
    with open(path) as f:
        got = json.load(f)
    row = {"phase": "nccl_world1", **got}
    emit(row)
    checks = {k: v for k, v in got.items() if isinstance(v, bool)}
    if not (all(checks.values()) and got["backend"] == "nccl" and got["device"] == "cuda:0"):
        raise AssertionError(f"nccl_world1: {row}")
    return row


# mesh_spatial_forward: bench.py's frames (numpy seed 0: frames 0, 8 and 16
# of its drifting sequence), float32, 'dequantize', H-sharded over 4 gloo
# ranks that share the card, for each family with a sharded forward. One
# B-frame (frame 8 between 0 and 16) of LHBDC(N=128) (main_path's model and
# seed; it has no zero-initialised head, so its seeded SPyNet already moves
# pixels), FlowGuidedB and DeformB at full width, heads seeded (main_path_v4's
# and main_path_v3's models), s=1.0, v4 at down ratio 1, and Flex-Rate
# (N=128, main_path_flexrate's model) at n=1, l=1.0; DMC's chain of two
# P-frames (feat 48, N 64, main_path_dmc's model): frame 8 at ratio 1.0 from
# frame 0 with an empty DPB, then frame 16 at ratio 1.5 (720 rows edge-padded
# to 768) from frame 8's sharded DPB; ELIC (N=192, M=320) on frame 8. The
# deep levels' shards are uneven and, at LHBDC's MV /64, one is empty
# (320 // 64 = 5 rows: 2, 2, 1, 0); the /16 latents' 68 rows start at 0, 17,
# 34, 51, odd on ranks 1 and 3 (the checkerboard's and DMC's parts' parity).
SPATIAL_RANKS = 4
SPATIAL_BITS_BAR = 1e-3     # relative
SPATIAL_FLIP_BAR = 1e-5     # share of quantized latents that round the other way
SPATIAL_X_HAT_BAR = 2e-4    # absolute, where no latent flipped (tpuvc's bar)
# Every process of the phase, the unsharded forward's and the ranks', runs
# under this cap of device memory. For the k3 convs at /8 with 192-320
# channels cuDNN's heuristics take a plan with a 12-20 GiB workspace where a
# process has the card alone, and PyTorch passes over a plan whose workspace
# it cannot allocate: four ranks sharing one card's 80 GB cannot all hold
# one, and a rank that falls back sums those convs otherwise (one rank in
# four did, in PR 14's runs). Under the cap all take the same plans.
SPATIAL_MEM_GIB = 10
SPATIAL_FAMILIES = {"lhbdc": {}, "flowguided_b": {"s": 1.0, "down_ratio": 1},
                    "deform_b": {"s": 1.0}, "flexrate": {"n": 1, "l": 1.0},
                    "dmc": {"q": 0.0}, "elic": {}}
SPATIAL_DMC_RATIOS = (1.0, 1.5)  # DMC's chain: frames 8 and 16
# Each family's quantized latents: {name: (codec, entropy model, rounded)}.
# ``rounded`` also keeps round(input): CondELIC and ELIC synthesise from
# round(y) and build their hyper prior from round(z), not from the entropy
# models' outputs (which round around the means and medians), so a latent
# has flipped where either rounds the other way. DMC's Laplace latents are
# round((y - means) * q_step), four parts a latent.
_COND_ELIC_LATENTS = {f"{short}_{v}": (codec, part, True)
                      for short, codec in (("off", "offset_compressor"),
                                           ("res", "residual_compressor"))
                      for v, part in (("y", "gaussian"), ("z", "entropy_bottleneck"))}


def _hyperprior_latents(mv: str, res: str, part: str = "gaussian") -> dict:
    return {f"{short}_{v}": (codec, p, False) for short, codec in (("mv", mv), ("res", res))
            for v, p in (("y", part), ("z", "entropy_bottleneck"))}


SPATIAL_LATENTS = {
    "lhbdc": _hyperprior_latents("mv_compressor", "residual_compressor"),
    "flowguided_b": _COND_ELIC_LATENTS,
    "deform_b": _COND_ELIC_LATENTS,
    "flexrate": _hyperprior_latents("flow_compressor", "residual_compressor"),
    "dmc": _hyperprior_latents("mv_coder", "y_coder", "laplace"),
    "elic": {"y": (None, "gaussian", True), "z": (None, "entropy_bottleneck", True)},
}


def spatial_inputs(torch, device, frame=FRAME, family: str = "lhbdc"):
    """(the family's seeded model, frames 0, 8 and 16) on ``device``:
    bench.py's frames at ``frame``. LHBDC(N=128) seeded as main_path's;
    FlowGuidedB, DeformB and Flex-Rate at full width as main_path_v4's,
    main_path_v3's and main_path_flexrate's (``v4_model``, ``v3_model``,
    ``flexrate_model``); DMC as main_path_dmc's (``dmc_model``); ELIC at
    N=192, M=320, seeded."""
    import numpy as np

    from tpuvc_torch.models.elic import ELIC
    from tpuvc_torch.models.lhbdc import LHBDC

    rng = np.random.default_rng(0)
    base = rng.random((*frame, 3), dtype=np.float32)
    drift = (0.01 * rng.standard_normal((*frame, 3))).astype(np.float32)
    xs = [torch.from_numpy(np.clip(base + i * drift, 0, 1))[None].to(device) for i in (0, 8, 16)]
    build = {"lhbdc": lambda: LHBDC(N=128, generator=torch.Generator().manual_seed(0)),
             "flowguided_b": lambda: v4_model(torch), "deform_b": lambda: v3_model(torch),
             "flexrate": lambda: flexrate_model(torch), "dmc": lambda: dmc_model(torch),
             "elic": lambda: ELIC(generator=torch.Generator().manual_seed(0))}
    return build[family]().to(device).eval(), xs


def spatial_steps(family: str) -> list:
    """[(run name, spatial_forward's family_args)]: the forwards
    mesh_spatial_forward makes of ``family``, one, or DMC's chain of
    P-frames (``SPATIAL_DMC_RATIOS``), each from the DPB before it."""
    kw = SPATIAL_FAMILIES[family]
    if family == "dmc":
        return [(f"dmc_frame{8 * (i + 1)}", {**kw, "ratio": r})
                for i, r in enumerate(SPATIAL_DMC_RATIOS)]
    return [(family, kw)]


def spatial_step_inputs(family: str, step: int, frames, dpb=None) -> tuple:
    """spatial_forward's positional inputs for ``family``'s step ``step``
    of ``frames`` (0, 8, 16; whole tensors or their Rows): the B-frame
    triple, ELIC's frame 8, or DMC's frame 8 (16) and the DPB (frame 0's
    empty one for the first)."""
    if family == "elic":
        return (frames[1],)
    if family == "dmc":
        return (frames[step + 1], {"ref_frame": frames[0]} if dpb is None else dpb)
    return tuple(frames)


def cap_device_memory(torch, gib) -> None:
    """Cap this process's device memory (PyTorch's caching allocator) at
    ``gib`` GiB of the card's, or lift the cap with None
    (``precision.cap_device_memory``, which the conv-plan windows keep
    within)."""
    from tpuvc_torch.ops.precision import cap_device_memory as cap

    cap(gib, "cuda:0")


def unsharded_forward(model, family: str, inputs, **family_args) -> dict:
    """The family's own ``dequantize`` forward of spatial_forward's
    positional ``inputs`` (``spatial_step_inputs``) with SPATIAL_FAMILIES'
    arguments and ``family_args``: {"x_hat", "bits", "dpb" (DMC's, else
    None)}."""
    kw = {**SPATIAL_FAMILIES[family], **family_args}
    if family == "lhbdc":
        out = model(*inputs, "dequantize")
        return {"x_hat": out["x_hat"], "bits": out["bits"], "dpb": None}
    if family == "elic":
        out = model(*inputs, "dequantize")
        return {"x_hat": out["x_hat"], "bits": model.bits(out["likelihoods"]), "dpb": None}
    if family == "dmc":
        out = model(*inputs, kw["ratio"], "dequantize", q=kw["q"])
        return {"x_hat": out["x_hat"], "bits": out["bits"], "dpb": out["dpb"]}
    if family == "flexrate":
        out = model(*inputs, kw["n"], kw["l"], "dequantize")
    else:
        xb, xc, xa = inputs
        if family == "flowguided_b":
            out = model(xb, xa, xc, kw["s"], 0.5, -0.5, kw["down_ratio"], "dequantize")
        else:
            out = model(xb, xa, xc, kw["s"], "dequantize")
    return {"x_hat": out["x_hat"], "bits": out["size"].sum(), "dpb": None}


class _KeepLatent:
    """Stands in for a codec's Gaussian or Laplace conditional (a plain
    object, which takes no forward hook): calls it and hands (its first
    output, its input) to ``keep``."""

    def __init__(self, inner, keep):
        self._inner, self._keep = inner, keep

    def __call__(self, *args, **kw):
        out = self._inner(*args, **kw)
        self._keep(out[0], args[0])
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def latent_hooks(model, family: str) -> dict:
    """Keep the quantized latents (the entropy models' first output, with
    round(input) stacked before it where SPATIAL_LATENTS says so) of the
    model's forwards under SPATIAL_LATENTS' names: a forward hook on each
    bottleneck, a _KeepLatent around each Gaussian or Laplace conditional
    (of the model itself where the codec is None). A model that calls one
    several times a forward (channel groups, DMC's parts) keeps a list of
    its outputs; clear the dict before the forward to keep."""
    import torch

    got = {}
    for name, (codec, part, rounded) in SPATIAL_LATENTS[family].items():
        def keep(q, x, name=name, rounded=rounded):
            got.setdefault(name, []).append(
                torch.stack([q.detach(), torch.round(x.detach())]) if rounded else q.detach()[None])

        owner = model if codec is None else getattr(model, codec)
        if part in ("gaussian", "laplace"):
            setattr(owner, part, _KeepLatent(getattr(owner, part), keep))
        else:
            getattr(owner, part).register_forward_hook(
                lambda mod, args, out, keep=keep: keep(out[0], args[0]))
    return got


def kept_latents(got: dict) -> dict:
    """latent_hooks' lists joined: {name: (views, B, H, W, C)} on the CPU,
    the calls of one forward side by side."""
    import torch

    return {k: torch.cat(v, dim=-1).cpu() for k, v in got.items()}


# Run by torchrun in each rank: joins a gloo group on the device named by the
# second argument; for each family of SPATIAL_FAMILIES builds spatial_inputs
# (frame H x W from the third), runs its spatial_steps once to warm up and
# once timed, each step with the launch counts set to 0 just before and read
# just after, and saves this rank's rows of x_hat, its rows of the quantized
# latents, the totals, its SpatialStats, the forward's ms and peak memory and
# the launched kernel shapes to OUT/spatial_RUN_RANK.pt; rank 0's file of a
# DMC step also holds its DPB, gathered.
MESH_SPATIAL_IN_RANKS = """
import dataclasses, os, sys, time
import torch
import torch.distributed as dist
import chip_smoke
from tpuvc_torch.ops.precision import set_deterministic
from tpuvc_torch.parallel import spatial as S
from tpuvc_torch.parallel.mesh import make_mesh
out_dir, device, frame = sys.argv[1], sys.argv[2], tuple(int(v) for v in sys.argv[3].split("x"))
mesh = make_mesh(backend="gloo", device=device)
cuda = mesh.device.type == "cuda"
if cuda:
    set_deterministic()
    chip_smoke.cap_device_memory(torch, chip_smoke.SPATIAL_MEM_GIB)
logged = chip_smoke.log_launches() if cuda else {"warp": set(), "deform": set(),
                                                 "epilogue": set()}
for family in chip_smoke.SPATIAL_FAMILIES:
    model, frames = chip_smoke.spatial_inputs(torch, mesh.device, frame, family)
    latents = chip_smoke.latent_hooks(model, family)
    rows = S.shard_spatial(mesh, frames)
    steps = chip_smoke.spatial_steps(family)
    for timed in (False, True):
        dpb = None
        for step, (run, kw) in enumerate(steps):
            inputs = chip_smoke.spatial_step_inputs(family, step, rows, dpb)
            stats = S.SpatialStats() if timed else None
            if timed:
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                dist.barrier()
                for shapes in logged.values():
                    shapes.clear()
                latents.clear()
                chip_smoke.reset_launches()
            t0 = time.perf_counter()
            out = S.spatial_forward(mesh, model, *inputs, stats=stats, **kw)
            if cuda:
                torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launches = chip_smoke.read_launches()
            dpb = out.get("dpb")
            if not timed:
                continue
            kept = None
            if step + 1 < len(steps):  # the next step's unsharded run starts from it
                kept = {k: S.gather_rows(mesh, v).cpu() for k, v in dpb.items()
                        if k != "ref_down_ratio"}
            torch.save({"rank": mesh.rank, "ms": ms, "launches": launches,
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
                        "x_hat": out["x_hat"].x.cpu(), "latents": chip_smoke.kept_latents(latents),
                        "bits": float(out["bits"]), "sizes": out["sizes"].cpu(),
                        "stats": dataclasses.asdict(stats),
                        "shapes": {k: sorted(v) for k, v in logged.items()},
                        "dpb": kept if mesh.rank == 0 else None},
                       os.path.join(out_dir, f"spatial_{run}_{mesh.rank}.pt"))
            del out, kept
    del model, frames, rows, latents, dpb
    if cuda:
        chip_smoke.release_cache(torch)
    dist.barrier()
dist.destroy_process_group()
"""


def _unsharded_run(torch, family: str, run: str, kw: dict, model, inputs, frame,
                   cuda: bool) -> tuple:
    """One step of ``family`` unsharded in this process, after a warm
    forward: (its mesh_spatial_forward row, x_hat, the kept latents, the
    bits) on the CPU."""
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    latents = latent_hooks(model, family)
    with torch.no_grad():
        unsharded_forward(model, family, inputs, **kw)
        sync()
        if cuda:
            # the timed forward starts as the warm one did, from an empty
            # cache: under the cap, the blocks the warm forward left cached,
            # split by the tensors that outlive them, need not fit the
            # timed forward's requests (a cache hand-back at the failing
            # conv cannot move those tensors)
            release_cache(torch)
            torch.cuda.reset_peak_memory_stats()
        latents.clear()
        reset_launches()
        t0 = time.perf_counter()
        ref = unsharded_forward(model, family, inputs, **kw)
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
    one = {"phase": "mesh_spatial_forward", "family": family, "run": run,
           "ranks": "one process, unsharded", "frame": list(frame), "family_args": kw,
           "mode": "dequantize", "compute_dtype": "float32", "forward_ms": ms,
           "launches": read_launches(),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}
    emit(one)
    return one, ref["x_hat"].cpu(), kept_latents(latents), float(ref["bits"])


def mesh_spatial_forward(torch, logged: dict, tmp: str, device: str = "cuda",
                         frame=FRAME) -> dict:
    """Each SPATIAL_FAMILIES forward (each of its ``spatial_steps``) with the
    frame's rows split over SPATIAL_RANKS gloo ranks on the card
    (tpuvc_torch.parallel.spatial, MESH_SPATIAL_IN_RANKS, one launch of the
    ranks for all families) against the same forward unsharded in this
    process, each after a warm forward, every process capped at
    SPATIAL_MEM_GIB of device memory. DMC's frame 16 runs unsharded after
    the ranks, from their gathered DPB of frame 8, so that each frame is
    judged on its own. Per run, one row for the unsharded run and one per
    rank (forward ms, peak GiB, warp and deform launches and their y0,
    bytes fetched, the share of warp samples and of deform taps in another
    rank's rows), then the comparison: x_hat's largest difference and share
    above 1e-4, the quantized latents that differ (by more than 0.5: a
    value that rounds the other way), the bits' relative difference. cuDNN
    picks its algorithm by shape, so a latent near a rounding edge may
    flip: the phase fails on bits off by more than SPATIAL_BITS_BAR, more
    than SPATIAL_FLIP_BAR of the latents flipped, x_hat off by more than
    SPATIAL_X_HAT_BAR where none flipped, a rank without a launch of each
    kernel of the family (FAMILY_KERNELS) or with launch counts other than
    its recorded warps and deform convs, ranks 1.. with a launch at y0 0,
    or no warp sample (no deform tap) in another rank's rows."""
    from tpuvc_torch.parallel.spatial import rows_of

    cuda = device == "cuda"
    if cuda:
        cap_device_memory(torch, SPATIAL_MEM_GIB)
    unsharded = {}
    for family in SPATIAL_FAMILIES:
        model, frames = spatial_inputs(torch, device, frame, family)
        run, kw = spatial_steps(family)[0]  # later DMC frames: after the ranks
        unsharded[run] = (family, *_unsharded_run(
            torch, family, run, kw, model, spatial_step_inputs(family, 0, frames), frame, cuda))
        del model, frames
        if cuda:
            release_cache(torch)
    if cuda:
        cap_device_memory(torch, None)
    out_dir = os.path.join(tmp, "spatial_ranks")
    os.makedirs(out_dir)
    launch_ranks(SPATIAL_RANKS, MESH_SPATIAL_IN_RANKS, [out_dir, device, "x".join(map(str, frame))],
                 720)
    if cuda:
        cap_device_memory(torch, SPATIAL_MEM_GIB)
    for family in SPATIAL_FAMILIES:
        steps = spatial_steps(family)
        if len(steps) == 1:
            continue
        model, frames = spatial_inputs(torch, device, frame, family)
        for step, (run, kw) in enumerate(steps[1:], 1):
            prev = torch.load(os.path.join(out_dir, f"spatial_{steps[step - 1][0]}_0.pt"),
                              weights_only=False)["dpb"]
            dpb = {**{k: v.to(device) for k, v in prev.items()},
                   "ref_down_ratio": steps[step - 1][1]["ratio"]}
            unsharded[run] = (family, *_unsharded_run(
                torch, family, run, kw, model, spatial_step_inputs(family, step, frames, dpb),
                frame, cuda))
            del dpb
        del model, frames
        if cuda:
            release_cache(torch)
    if cuda:
        cap_device_memory(torch, None)
    result, fails = {}, []
    for run, (family, one, x_ref, lat_ref, bits_ref) in unsharded.items():
        ranks = [torch.load(os.path.join(out_dir, f"spatial_{run}_{r}.pt"), weights_only=False)
                 for r in range(SPATIAL_RANKS)]
        rows = []
        for r in ranks:
            st = r["stats"]
            for kernel in logged:
                logged[kernel].update(tuple(v) for v in r["shapes"][kernel])
            rows.append({
                "phase": "mesh_spatial_forward", "family": family, "run": run,
                "ranks": f"rank {r['rank']} of {SPATIAL_RANKS}",
                "rows": list(rows_of(frame[0], SPATIAL_RANKS, r["rank"])),
                "forward_ms": r["ms"], "peak_mem_gib": r["peak_mem_gib"],
                "launches": r["launches"], "warps_y0_rows_H_B_C": st["warps"],
                "deforms_y0_rows_H_B_C": st["deforms"],
                "bytes_fetched": st["bytes_fetched"], "fetches": st["fetches"],
                "warp_samples_in_other_ranks_rows": st["samples_elsewhere"] / max(1, st["samples"]),
                "deform_taps_in_other_ranks_rows": st["taps_elsewhere"] / max(1, st["taps"])})
            emit(rows[-1])
        x_hat = torch.cat([r["x_hat"] for r in ranks], dim=1)
        d = (x_hat - x_ref).abs()
        flipped = {k: int(((torch.cat([r["latents"][k] for r in ranks], dim=2) - v).abs() > 0.5)
                          .any(dim=0).sum()) for k, v in lat_ref.items()}
        n_latents = sum(v[0].numel() for v in lat_ref.values())
        bits = ranks[0]["bits"]

        def share(hit, total):
            n = sum(r["stats"][total] for r in ranks)
            return sum(r["stats"][hit] for r in ranks) / n if n else None

        summary = {
            "phase": "mesh_spatial_forward", "family": family, "run": run,
            "ranks": f"{SPATIAL_RANKS} sharded vs unsharded",
            "frame": list(frame), "dist_backend": "gloo" if cuda else "gloo (CPU)",
            "ranks_share_one_card": cuda,
            "x_hat_shape": list(x_hat.shape), "x_hat_max_abs_diff": float(d.max()),
            "x_hat_share_above_1e-4": float((d > 1e-4).float().mean()),
            "latents_flipped": flipped, "latents": n_latents,
            "latents_flipped_share": sum(flipped.values()) / n_latents,
            "bits": bits, "bits_unsharded": bits_ref,
            "bits_rel_diff": abs(bits - bits_ref) / bits_ref,
            "ranks_bits_equal": len({r["bits"] for r in ranks}) == 1,
            "bytes_fetched_per_forward": sum(r["stats"]["bytes_fetched"] for r in ranks),
            "warp_samples_in_other_ranks_rows": share("samples_elsewhere", "samples"),
            "deform_taps_in_other_ranks_rows": share("taps_elsewhere", "taps"),
            "forward_ms_slowest_rank": max(r["ms"] for r in ranks),
            "forward_ms_unsharded": one["forward_ms"],
        }
        emit(summary)
        bad = []
        if not summary["bits_rel_diff"] <= SPATIAL_BITS_BAR:
            bad.append("bits")
        if not summary["latents_flipped_share"] <= SPATIAL_FLIP_BAR:
            bad.append("flipped latents")
        if sum(flipped.values()) == 0 and not summary["x_hat_max_abs_diff"] <= SPATIAL_X_HAT_BAR:
            bad.append("x_hat")
        if list(x_hat.shape) != [1, *frame, 3] or not bool(torch.isfinite(x_hat).all()):
            bad.append("x_hat shape or finiteness")
        if not summary["ranks_bits_equal"]:
            bad.append("ranks' totals")
        for kernel, what, hit in (("warp", "warps", "warp_samples_in_other_ranks_rows"),
                                  ("deform", "deforms", "deform_taps_in_other_ranks_rows")):
            for r, row in zip(ranks, rows):
                if cuda and r["launches"][kernel] != len(row[f"{what}_y0_rows_H_B_C"]):
                    bad.append(f"rank {r['rank']}'s {kernel} launch count")
            if kernel not in FAMILY_KERNELS[family]:
                continue
            if not summary[hit]:
                bad.append(f"no {kernel} sample in another rank's rows")
            for r, row in zip(ranks, rows):
                done = row[f"{what}_y0_rows_H_B_C"]
                if not done or (r["rank"] > 0 and 0 in {w[0] for w in done}):
                    bad.append(f"rank {r['rank']}'s {kernel} launches")
        fails += [f"{run}: {b}" for b in bad]
        result[run] = {"one_process": one, "ranks": rows, "summary": summary}
    if fails:
        raise AssertionError(f"mesh_spatial_forward: {fails}")
    return result


def warp_and_blend_check(torch) -> dict:
    """``ops.warp.warp_and_blend`` on CUDA tensors at LHBDC's
    motion-compensation shape (4,1088,1920,3), lhbdc mode: two warp kernel
    launches, bit for bit the blend of two ``warp_plain`` calls."""
    from tpuvc_torch.ops import warp as W

    gen = torch.Generator(device="cuda").manual_seed(7)
    shape = (4, 1088, 1920, 3)
    img_fw, img_bw = (torch.rand(shape, generator=gen, device="cuda") for _ in range(2))
    flow_fw, flow_bw = (4.0 * torch.randn((*shape[:3], 2), generator=gen, device="cuda")
                        for _ in range(2))
    mask = torch.rand((*shape[:3], 1), generator=gen, device="cuda")
    args = (img_fw, flow_fw, img_bw, flow_bw, mask, "lhbdc")
    before = W.warp_kernel.launches
    out = W.warp_and_blend(*args)
    launched = W.warp_kernel.launches - before

    def plain():
        return (mask * W.warp_plain(img_fw, flow_fw, "lhbdc")
                + (1.0 - mask) * W.warp_plain(img_bw, flow_bw, "lhbdc"))

    ref = plain()
    torch.cuda.synchronize()
    row = {"phase": "warp_and_blend", "shape": list(shape), "compat": "lhbdc",
           "kernel_launches": launched, "max_abs_err": float((out - ref).abs().max()),
           "bit_exact": bool(torch.equal(out, ref)),
           "ms": time_ms(torch, lambda: W.warp_and_blend(*args), 20),
           "plain_ms": time_ms(torch, plain, 3, 1)}
    emit(row)
    if not (row["bit_exact"] and launched == 2):
        raise AssertionError(f"warp_and_blend: {row}")
    return row


def pmf_native_check() -> dict:
    """The port's native pmf -> quantized CDF (coder/csrc/rans.cpp) against
    the numpy quantizer on 50 random pmfs, as tpuvc's
    TestNativeCdfQuantizer holds tpuvc's: equal arrays."""
    import numpy as np

    from tpuvc_torch.coder.rans import pmf_to_quantized_cdf_native
    from tpuvc_torch.entropy.cdf import pmf_to_quantized_cdf

    rng = np.random.default_rng(0)
    equal = 0
    for trial in range(50):
        n = int(rng.integers(1, 300))
        pmf = rng.random(n) ** 3
        if trial % 3 == 0:
            pmf[rng.integers(0, n)] = 0.0
        equal += bool(np.array_equal(pmf_to_quantized_cdf_native(pmf), pmf_to_quantized_cdf(pmf)))
    row = {"phase": "pmf_native", "pmfs": 50, "equal": equal}
    emit(row)
    if equal != 50:
        raise AssertionError(f"pmf_to_quantized_cdf_native differs from numpy: {row}")
    return row


def epilogue_simple(torch, y, bias=None, act=None, slope=0.01, residual=None):
    """The simplest rewrite of the conv epilogue in PyTorch ops that keeps
    its bits, as a yardstick: one promoting add (bf16 + f32 bias), then the
    residual and the activation in place."""
    import torch.nn.functional as F

    out = y.permute(0, 2, 3, 1)
    out = out.float() if bias is None else out + bias
    if residual is not None:
        out.add_(residual)
    if act == "relu":
        out.relu_()
    elif act == "leaky_relu":
        F.leaky_relu_(out, slope)
    return out


def epilogue_check(torch) -> list[dict]:
    """The epilogue kernel against epilogue_plain at EPILOGUE_SHAPES (the
    conv output in cuDNN's channels-last memory, seeded): bit for bit;
    kernel, plain-ops and :func:`epilogue_simple` times, and the byte bound
    (the conv output read once, the float32 result written once, a residual
    read once)."""
    from tpuvc_torch.ops import epilogue as E

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    with torch.no_grad():
        for name, (B, H, W, C), dt, act, slope, res, has_bias in EPILOGUE_SHAPES:
            dtype = getattr(torch, dt)
            y = torch.randn((B, H, W, C), generator=gen, device="cuda").to(dtype)
            y = y.permute(0, 3, 1, 2)
            bias = torch.randn(C, generator=gen, device="cuda") if has_bias else None
            r = torch.randn((B, H, W, C), generator=gen, device="cuda") if res else None
            args = (y, bias, act, slope, r)
            before = E.epilogue_kernel.launches
            out_k = E.epilogue(*args)
            launched = E.epilogue_kernel.launches - before
            out_p = E.epilogue_plain(*args)
            out_s = epilogue_simple(torch, *args)
            torch.cuda.synchronize()
            bit_exact = bool(torch.equal(out_k.view(torch.int32), out_p.view(torch.int32)))
            simple_bit_exact = bool(torch.equal(out_s.view(torch.int32),
                                                out_p.view(torch.int32)))
            del out_k, out_p, out_s
            n = B * H * W * C
            nbytes = n * y.element_size() + 4 * n + (4 * n if res else 0)
            iters = max(3, min(50, int(2e10 // nbytes)))
            row = {"phase": "epilogue_check", "shape_name": name, "shape": [B, H, W, C],
                   "dtype": dt, "act": act, "slope": slope, "residual": res,
                   "bias": has_bias, "launches": launched, "bit_exact": bit_exact,
                   "max_abs_err": 0.0 if bit_exact else None,
                   "ms": time_ms(torch, lambda: E.epilogue(*args), iters),
                   "plain_ms": time_ms(torch, lambda: E.epilogue_plain(*args), iters),
                   "simple_ms": time_ms(torch, lambda: epilogue_simple(torch, *args), iters),
                   "simple_bit_exact": simple_bit_exact,
                   "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}
            emit(row)
            rows.append(row)
            del y, bias, r, args
            torch.cuda.empty_cache()
    bad = [r for r in rows if not (r["bit_exact"] and r["launches"] == 1)]
    if bad:
        raise AssertionError(f"epilogue kernel differs from epilogue_plain: {bad}")
    return rows


def build_kernels() -> dict:
    """Build the CUDA kernels (one nvcc each, all started together) and the
    rANS library; returns the seconds each took."""
    from tpuvc_torch.coder import rans
    from tpuvc_torch.ops import deform, epilogue, warp

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    builds = {"warp_s": warp.build_kernel, "deform_s": deform.build_kernel,
              "epilogue_s": epilogue.build_kernel, "rans_s": rans.build}
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futs = {k: pool.submit(timed, fn) for k, fn in builds.items()}
        return {k: f.result() for k, f in futs.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench_torch import nvidia_smi
    from tpuvc_torch.ops.precision import set_deterministic

    set_deterministic()

    with phase("device", 60):
        smi = nvidia_smi()
        card = torch.cuda.get_device_name(0)
        emit({"phase": "device", "name": card, "nvidia_smi": smi,
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})

    with phase("build", 300):
        emit({"phase": "build", **build_kernels()})
        logged = log_launches()

    with phase("warp_check", 300):
        warp_rows = warp_check(torch)
    with phase("warp_and_blend", 60):
        warp_and_blend_check(torch)
    with phase("pmf_native", 60):
        pmf_native_check()
    with phase("deform_check", 360):
        deform_rows = deform_check(torch)
    with phase("epilogue_check", 180):
        epilogue_rows = epilogue_check(torch)
    with phase("train_kernel_check", 240):
        train_krows = train_kernel_check(torch)
    with phase("reference_check", 120):
        reference_check(torch)
    with phase("reference_check_v4", 120):
        reference_check_v4(torch)
    with phase("reference_check_v3", 120):
        reference_check_v3(torch)
    with phase("reference_check_flexrate", 120):
        reference_check_flexrate(torch)
    with phase("reference_check_train", 120):
        reference_check_train(torch)
    with phase("main_path", 300):
        lhbdc = main_path(torch)
    with phase("main_path_v4", 420):
        v4 = main_path_v4(torch)
    with phase("main_path_v3", 300):
        v3 = main_path_v3(torch)
    with phase("main_path_flexrate", 300):
        flexrate = main_path_flexrate(torch)
    streams_tmp = tempfile.TemporaryDirectory()
    streams = {"dir": streams_tmp.name, "paths": PRESSURE_PATHS}
    with phase("sequence_cli", 600):
        seq_rows = sequence_cli(torch, SEQUENCE_RUNS)
    with phase("sequence_cli_v3_flexrate", 420):
        seq_rows += sequence_cli(torch, SEQUENCE_RUNS_V3_FLEXRATE, intra=False,
                                 streams=streams)
    with phase("eval_cli", 300):
        eval_rows = eval_cli(torch, EVAL_RUNS)
    with phase("eval_cli_v3_flexrate", 300):
        eval_rows += eval_cli(torch, EVAL_RUNS_V3_FLEXRATE)
    with phase("reference_check_dmc", 120):
        reference_check_dmc(torch)
    with phase("main_path_dmc", 300):
        dmc = main_path_dmc(torch)
    with phase("sequence_cli_dmc", 300):
        seq_dmc = sequence_cli_dmc(torch, streams)
    with phase("decode_under_memory_pressure", 300):
        pressure_rows = decode_under_memory_pressure(torch, streams)
    streams_tmp.cleanup()
    with phase("eval_cli_dmc", 240):
        eval_rows += eval_cli(torch, EVAL_RUNS_DMC, warm=False)
    train_tmp = tempfile.TemporaryDirectory()
    with phase("train_cli", 600):
        train_rows = train_cli(torch, logged, train_tmp.name)
    with phase("train_determinism", 60):
        train_determinism(train_rows)
    with phase("trained_checkpoint_codes", 180):
        trained = trained_checkpoint_codes(torch, train_tmp.name)
    train_tmp.cleanup()
    imported_tmp = tempfile.TemporaryDirectory()
    with phase("imported_checkpoint_codes", 240):
        imported = imported_checkpoint_codes(torch, imported_tmp.name)
    with phase("image_eval_cli", 180):
        image_eval_cli(torch, os.path.join(imported["weights"], "elic"), imported_tmp.name)
    imported_tmp.cleanup()
    mesh_tmp = tempfile.TemporaryDirectory()
    with phase("mesh_sequence_cli", 420):
        mesh_rows = mesh_sequence_cli(torch, logged, mesh_tmp.name)
        level_batch_shape_dependence(torch)
    with phase("mesh_train_cli", 300):
        mesh_train = mesh_train_cli(torch, logged, mesh_tmp.name)
    with phase("nccl_world1", 180):
        nccl_world1(mesh_tmp.name)
    with phase("mesh_spatial_forward", 900):
        spatial = mesh_spatial_forward(torch, logged, mesh_tmp.name)
    mesh_tmp.cleanup()
    with phase("adaptive_ratios", 180):
        adaptive = adaptive_ratios(torch)
    with phase("bench_torch", 480):
        bench = bench_torch_run(torch)
    with phase("path_shapes_check", 360):
        path_rows = path_shapes_check(torch, logged, warp_rows, deform_rows, epilogue_rows)

    def by_path(kernel):
        paths = {"lhbdc": lhbdc["launches"][kernel], "flowguided_b": v4["launches"][kernel],
                 "deform_b": v3["launches"][kernel], "flexrate": flexrate["launches"][kernel],
                 "sequence_cli_dmc": seq_dmc["launches"][kernel]}
        if kernel == "warp":
            paths.update({f"dmc_ratio_{r}": v["warp_launches"]
                          for r, v in dmc["per_ratio"].items()})
        else:
            paths["dmc"] = dmc["launches"][kernel]
        paths.update({f"sequence_cli_{r['path']}": r["launches"][kernel] for r in seq_rows})
        paths.update({f"eval_cli_{r['path']}": r["launches"][kernel] for r in eval_rows})
        paths.update({f"decode_under_memory_pressure_{r['path']}": r["launches"][kernel]
                      for r in pressure_rows})
        paths["adaptive_ratios"] = adaptive["launches"][kernel]
        # bench_torch.py zeroes its counts before its timed coding windows
        # and again before its timed eval passes
        paths["bench_torch"] = bench["record"]["launches"][kernel]
        paths["bench_torch_eval"] = bench["record"]["eval_launches"][kernel]
        # the train CLI's subprocesses count their own launches (their summary)
        paths.update({r["path"]: r["launches"][kernel] for r in train_rows})
        paths["trained_checkpoint_encode_b"] = trained["launches"][kernel]
        paths.update({r["path"]: r["launches"][kernel] for r in imported["codes"].values()})
        # each rank of the mesh paths counts its own launches
        for r in mesh_rows:
            for verb, by_rank in r["launches_by_rank"].items():
                paths.update({f"mesh_sequence_cli_{r['path']}_{verb}_rank{k}": v[kernel]
                              for k, v in enumerate(by_rank)})
        paths.update({f"mesh_train_cli_rank{k}": v[kernel]
                      for k, v in enumerate(mesh_train["launches_by_rank"])})
        paths.update({f"mesh_spatial_forward_{family}_rank{k}": r["launches"][kernel]
                      for family, run in spatial.items() for k, r in enumerate(run["ranks"])})
        return paths

    warp_head = warp_rows[0]  # the largest shape: SPyNet's finest level
    # The deform kernel's headline: the v4 path's largest level, smooth offsets.
    deform_head = next(r for r in deform_rows if r["level"] == "L1" and r["x_shape"][0] == 2
                       and r["spread"] == "smooth_5px" and r["y0"] == 0)
    # Each kernel on the v3 and Flex-Rate paths: Flex-Rate's warp at B=1 and
    # DeformB's largest level (smooth offsets, the <V=4, MAXO=8> instance).
    slice_heads = {
        "warp": next(r for r in warp_rows if r["compat"] == "flexrate" and r["shape"][0] == 1),
        "deform": next(r for r in deform_rows if r["level"] == "v3 L1" and r["x_shape"][0] == 2
                       and r["spread"] == "smooth_5px" and r["y0"] == 0),
    }
    # The warp on the DMC path: its 48-channel feature warp at 1088x1920.
    dmc_head = next(r for r in warp_rows if r["shape"] == [1, 1088, 1920, 48])
    # Each kernel with a row offset: rank 1's rows of SPyNet's finest level,
    # rank 1's rows of v4's largest deform level.
    spatial_heads = {"warp": next(r for r in warp_rows if r["y0"] > 0),
                     "deform": next(r for r in deform_rows if r["y0"] > 0)}
    kernels = []
    for kernel, head, rows, replaces in (
        ("warp", warp_head, warp_rows, "tpuvc/ops/warp_pallas.py:103"),
        ("deform", deform_head, deform_rows, "tpuvc/ops/deform_pallas.py:101"),
    ):
        rows = rows + [r for r in path_rows if r["kernel"] == kernel]
        launches = by_path(kernel)
        kernels.append({
            "name": kernel, "route": "cuda", "source": f"tpuvc_torch/csrc/{kernel}.cu",
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": head.get("shape", head.get("x_shape")),
            "v3_flexrate_head": {k: slice_heads[kernel].get(k) for k in (
                "shape", "x_shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
        if kernel == "warp":
            kernels[-1]["dmc_head"] = {k: dmc_head[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        row_keys = ("compat", "shape", "x_shape", "y0", "rows", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")
        kernels[-1]["spatial_head"] = {k: spatial_heads[kernel].get(k) for k in row_keys}
        if kernel == "warp":  # every row-offset row: each mode and width the ranks warp at
            kernels[-1]["row_offset_rows"] = [{k: r.get(k) for k in row_keys} for r in warp_rows
                                              if r["rows"] != r["shape"][1]]
        # the largest training shape: forward, and the forward and backward
        # training runs (deterministic algorithms), with the backward's bound
        train_head = max((r for r in train_krows if r["kernel"] == kernel),
                         key=lambda r: r["fwd_ms"])
        kernels[-1]["train_head"] = {k: train_head.get(k) for k in (
            "shape", "x_shape", "fwd_ms", "fwd_bwd_ms", "fwd_bwd_ms_with_atomics",
            "bwd_repeat_bit_identical", "plain_fwd_bwd_ms", "library_fwd_bwd_ms", "bound_ms",
            "bound_by", "bwd_bound_ms", "bwd_bound_by")}
    # The epilogue: no TPU kernel to replace (XLA fused the conv's epilogue);
    # its headline is SPyNet's conv1 at batch 8.
    epilogue_head = epilogue_rows[0]
    launches = by_path("epilogue")
    shape_keys = ("shape_name", "shape", "dtype", "act", "residual", "ms", "plain_ms",
                  "simple_ms", "simple_bit_exact", "bound_ms")
    kernels.append({
        "name": "epilogue", "route": "cuda", "source": "tpuvc_torch/csrc/epilogue.cu",
        "replaces": "none", "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in epilogue_rows + path_rows
                           if r.get("kernel", "epilogue") == "epilogue"),
        "ms": epilogue_head["ms"], "plain_ms": epilogue_head["plain_ms"],
        "simple_ms": epilogue_head["simple_ms"], "bound_ms": epilogue_head["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shape": epilogue_head["shape"],
        "rows": [{k: r[k] for k in shape_keys} for r in epilogue_rows],
    })
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
