#!/usr/bin/env python3
"""Smoke run of the tpuvc_torch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

It builds the port's kernels from the sources in the checkout, holds each
against its plain PyTorch version at the shapes the paths give it, and
drives the paths with seeded weights: LHBDC(N=128) codes a GOP-16, 2-GOP
window of 1088x1920 B-frames at batch 4 to real rANS streams, FlowGuidedB
(v4, full width) and DeformB (v3, full width) code the same window at batch
2 and Flex-Rate (v2, N=128) at batch 4, the DMC P-frame codec (feat 48,
N 64) codes a chain of 1088x1920 P-frames, the encode_v / decode_v and
encode_p / decode_p CLIs code whole synthetic sequences (ELIC intra + B-
or P-frames) to a file and back, the RD-eval CLI evaluates a sequence,
FlowGuidedB codes at every down ratio, and bench_torch.py runs bench.py's
measurement; each decode must reproduce its encoder's reconstructions bit
for bit. Each phase runs
under its own time limit and prints JSON lines:

  device             card name, power limit, software versions
  build              warp and deform kernels (nvcc, in parallel) and rANS
                     library (g++) build times
  warp_check         kernel vs warp_plain per shape: max abs error (<= 1e-5)
                     and bit for bit,
                     kernel / plain / F.grid_sample times, byte bound
  deform_check       kernel vs deform_plain at the v4 and v3 paths' three
                     shapes each (16 and 8 groups; batch 2: three offset
                     spreads; batch 1: smooth): max
                     abs error (<= 2e-5), kernel / plain times, byte and
                     operation bounds; at the largest shape and spread, two
                     launches must give the same bits
  reference_check    small LHBDC forward on the card vs the same on the CPU
  reference_check_v4 small full-width FlowGuidedB forward, card vs CPU
  reference_check_v3 the same for DeformB, reference_check_flexrate for
                     Flex-Rate, reference_check_dmc for DMC (two chained
                     P-frames at down ratios 1.0 and 1.5)
  main_path          LHBDC: B-frames/s, bpp, PSNR, decode_bit_exact, warp
                     launches, peak device memory
  main_path_v4       FlowGuidedB: the same, with deform launches and the
                     flow and offset spread it measured
  main_path_v3       DeformB: the same (deform launches, offset spread)
  main_path_flexrate Flex-Rate: the same (warp launches, the predicted
                     flow's and coded refinement's spread)
  main_path_dmc      DMC at batch 1 from a source-frame DPB: 16 chained
                     P-frames at down ratio 1.0, then 4 at 1.5, encoded
                     (encode_async) and decoded (decode_sequence): P-frames/s,
                     bpp, PSNR, decode_bit_exact, warp launches, the spread
                     of SPyNet's flow and of the decoded MV, peak memory
  sequence_cli       the port's CLIs as a user runs them: encode_v codes
                     synthetic 1088x1920 frames (ELIC intra anchors and
                     B-frames) to one file, decode_v decodes it in another
                     process; one row per run (LHBDC level-batched 33
                     frames, FlowGuidedB sequential 17 frames at down ratio
                     1 and with --adaptive, its flow and offset heads seeded
                     in both processes): frames/s, intra ms per frame, bpp,
                     PSNR, decode_bit_exact, launches, peak device memory,
                     the down ratios --adaptive chose
  sequence_cli_v3_flexrate  the same for DeformB and Flex-Rate, level-batched
                     33 frames each at their windows' batch caps
  sequence_cli_dmc   encode_p --adaptive on 17 synthetic 1088x1920 frames
                     (ELIC I-frame, 16 DMC P-frames), decode_p in a fresh
                     process: frames/s, intra ms per frame, bpp, the down
                     ratios chosen, decode_bit_exact by sha256, peak memory
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
  adaptive_ratios    FlowGuidedB coded at down ratios 2, 4, 8, 16, each
                     stream decoded bit for bit
  bench_torch        bench_torch.py in a subprocess: its last record must
                     be bit-exact, with two timed windows and eval_fps;
                     its launches are those of its timed coding windows
                     and, apart, of its timed eval passes
  path_shapes_check  every kernel shape the paths launched in this process
                     that the checks above did not cover, held against the
                     plain version (bench_torch.py's shapes are a subset of
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
import os
import signal
import subprocess
import sys
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

# The coded window: bench.py's frame size and GOP, two GOPs.
FRAME, GOP, WINDOW_GOPS = (1088, 1920), 16, 2

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


def deform_ops(B, H, W, G, Cg, Og, T=DEFORM_TAPS) -> int:
    """float32 operations of one deform conv: per (pixel, group, tap) ~18
    for the sample point and corner weights, 8 per channel (4-corner blend,
    mask), 2 per (channel, output), 1 per output; then the bias."""
    return B * H * W * G * (T * (18 + 8 * Cg + 2 * Cg * Og + Og) + Og)


def emit(payload) -> None:
    print(json.dumps(payload), flush=True)


@contextlib.contextmanager
def phase(name: str, limit_s: int):
    """Run a phase under a SIGALRM time limit; the timeout raises."""

    def on_alarm(signum, frame):
        raise TimeoutError(f"phase {name} exceeded {limit_s} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(limit_s)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


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
    import torch.nn.functional as F

    from tpuvc_torch.ops import warp as W

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for compat, shape in WARP_SHAPES:
        B, H, Wd, C = shape
        img = torch.rand(shape, generator=gen, device="cuda")
        flow = 4.0 * torch.randn((B, H, Wd, 2), generator=gen, device="cuda")
        out_k = W.warp(img, flow, compat)
        out_p = W.warp_plain(img, flow, compat)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        bit_exact = bool(torch.equal(out_k, out_p))
        del out_k, out_p
        if not (err <= 1e-5 and bit_exact):
            raise AssertionError(f"warp {compat} {shape}: max abs err {err}, bit_exact {bit_exact}")

        # One F.grid_sample call for the same sampling, as a yardstick only.
        sx, sy, zero = W._scales(compat, H, Wd)
        shift = -0.5 if zero else 0.0
        xs = torch.arange(Wd, device="cuda", dtype=torch.float32)
        ys = torch.arange(H, device="cuda", dtype=torch.float32)
        gx = (xs + (flow[..., 0] + shift) * sx) * (2.0 / (Wd - 1)) - 1.0
        gy = (ys[:, None] + (flow[..., 1] + shift) * sy) * (2.0 / (H - 1)) - 1.0
        grid = torch.stack([gx, gy], dim=-1)
        img_nchw = img.permute(0, 3, 1, 2).contiguous()
        pad = "zeros" if zero else "border"

        iters = 20 if B * H * Wd > 1e6 else 200
        ms = time_ms(torch, lambda: W.warp(img, flow, compat), iters)
        plain_ms = time_ms(torch, lambda: W.warp_plain(img, flow, compat), 3, 1)
        library_ms = time_ms(
            torch,
            lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                  padding_mode=pad, align_corners=True),
            iters,
        )
        n_out = B * H * Wd * C
        bytes_moved = 4 * (2 * n_out + 2 * B * H * Wd)
        bound_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
        bound_ops = 1e3 * WARP_OPS_PER_ELEMENT * n_out / F32_OPS_PER_S
        row = {
            "phase": "warp_check", "compat": compat, "shape": list(shape),
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
    frame)."""
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
                "x_shape": [B, H, W, C], "groups": G, "out_channels": C_out,
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
    ``fn``, then launches. ``dims`` picks them from the C call's arguments."""

    def __init__(self, lib, fn: str, dims: slice):
        self._lib, self._fn, self._dims = lib, fn, dims
        self.shapes: set = set()

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != self._fn:
            return fn

        def launch(*args):
            self.shapes.add(tuple(args[self._dims]))
            return fn(*args)

        return launch


def log_launches() -> dict:
    """Put a LaunchLog in front of each built kernel library. Keys: warp
    (B, H, W, C, sx, sy, zero), deform (B, H, W, G, Cg, Og, K)."""
    from tpuvc_torch.ops import deform, warp

    warp._lib = LaunchLog(warp._get_lib(), "tpuvc_warp_bilinear_nhwc", slice(3, 10))
    deform._lib = LaunchLog(deform._get_lib(), "tpuvc_deform_conv_nhwc", slice(6, 13))
    return {"warp": warp._lib.shapes, "deform": deform._lib.shapes}


def path_shapes_check(torch, logged: dict, warp_rows, deform_rows) -> list[dict]:
    """Every warp and deform shape a path launched that warp_check and
    deform_check did not hold against the plain versions (SPyNet's middle
    pyramid levels, for one): the kernel against warp_plain's sampling
    (bit for bit) and deform_plain (smooth +-5 px offsets, <= 2e-5) once,
    on seeded inputs."""
    from tpuvc_torch.ops import deform as D
    from tpuvc_torch.ops import warp as W

    checked_warp = set()
    for r in warp_rows:
        B, H, Wd, C = r["shape"]
        sx, sy, zero = W._scales(r["compat"], H, Wd)
        checked_warp.add((B, H, Wd, C, sx, sy, int(zero)))
    checked_deform = {(*r["x_shape"][:3], r["groups"], r["x_shape"][3] // r["groups"],
                       r["out_channels"] // r["groups"], 3) for r in deform_rows}
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for key in sorted(logged["warp"] - checked_warp):
        B, H, Wd, C, sx, sy, zero = key
        img = torch.rand((B, H, Wd, C), generator=gen, device="cuda")
        flow = 4.0 * torch.randn((B, H, Wd, 2), generator=gen, device="cuda")
        out_k = W.warp_kernel(img, flow, sx, sy, bool(zero))
        out_p = W._warp_plain_sampled(img, flow - 0.5 if zero else flow, sx, sy, bool(zero))
        rows.append({"phase": "path_shapes_check", "kernel": "warp", "shape": [B, H, Wd, C],
                     "sx": sx, "sy": sy, "zero": bool(zero),
                     "max_abs_err": float((out_k - out_p).abs().max()),
                     "bit_exact": bool(torch.equal(out_k, out_p))})
        emit(rows[-1])
        if not rows[-1]["bit_exact"]:
            raise AssertionError(f"warp at a path's shape differs from warp_plain: {rows[-1]}")
    for key in sorted(logged["deform"] - checked_deform):
        B, H, Wd, G, Cg, Og, K = key
        x, masks, weight, bias = deform_inputs(torch, gen, B, H, Wd, G * Cg, G * Og, G, K * K)
        off = smooth_offsets(torch, gen, B, H, Wd, G * K * K * 2)
        args = (x, off, masks, weight, bias, G, K)
        err = float((D.deform_kernel(*args) - D.deform_plain(*args)).abs().max())
        rows.append({"phase": "path_shapes_check", "kernel": "deform",
                     "x_shape": [B, H, Wd, G * Cg], "groups": G, "out_channels": G * Og,
                     "spread": "smooth_5px", "max_abs_err": err})
        emit(rows[-1])
        if not err <= 2e-5:
            raise AssertionError(f"deform at a path's shape differs from deform_plain: {rows[-1]}")
    emit({"phase": "path_shapes_check", "warp_shapes_launched": len(logged["warp"]),
          "deform_shapes_launched": len(logged["deform"]), "checked_here": len(rows)})
    return rows


def reset_launches() -> None:
    from tpuvc_torch.ops import deform, warp

    warp.warp_kernel.launches = 0
    deform.deform_kernel.launches = 0


def read_launches() -> dict:
    from tpuvc_torch.ops import deform, warp

    return {"warp": warp.warp_kernel.launches, "deform": deform.deform_kernel.launches}


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
DMC_CHAIN = ((1.0, 16), (1.5, 4))
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
                  "deform_b": ["deform"], "flexrate": ["warp"], "dmc": ["warp"]}

# The CLI runs of sequence_cli: (path name, family, encode_v arguments).
# LHBDC takes bench.py's window settings with real ELIC anchors; FlowGuidedB
# runs the sequential mode, at down ratio 1 and with the per-frame
# down-ratio search (--adaptive).
SEQUENCE_V4 = ["--family", "flowguided_b", "--synthetic", "17", "--gop", "16",
               "--compute_dtype", "bfloat16", "--s", "1.0"]
SEQUENCE_RUNS = [
    ("lhbdc", "lhbdc", [
        "--family", "lhbdc", "--synthetic", "33", "--gop", "16", "--level_batched",
        "--max_batch", "4", "--window_gops", "2", "--compute_dtype", "bfloat16",
        "--l", "845"]),
    ("flowguided_b", "flowguided_b", SEQUENCE_V4),
    ("flowguided_b_adaptive", "flowguided_b", SEQUENCE_V4 + ["--adaptive"]),
]
# DeformB and Flex-Rate take their windows' settings (main_path_v3,
# main_path_flexrate) with real ELIC anchors, level-batched, 33 frames.
SEQUENCE_RUNS_V3_FLEXRATE = [
    ("deform_b", "deform_b", [
        "--family", "deform_b", "--synthetic", "33", "--gop", "16", "--level_batched",
        "--max_batch", "2", "--window_gops", "2", "--compute_dtype", "bfloat16",
        "--s", "1.0"]),
    ("flexrate", "flexrate", [
        "--family", "flexrate", "--synthetic", "33", "--gop", "16", "--level_batched",
        "--max_batch", "4", "--window_gops", "2", "--compute_dtype", "bfloat16",
        "--n", "1", "--interp", "0.66"]),
]
SEQUENCE_SIZE = ["--width", str(FRAME[1]), "--height", str(FRAME[0])]
SEQUENCE_MODEL = ["--init", "random", "--device", "cuda"]

# Run in a fresh interpreter by sequence_cli and sequence_cli_dmc, from the
# repository root: the main of the decoding CLI named by the first argument
# (decode_v or decode_p) on the other arguments, twice (a cold process,
# then warm), with the zero-initialised heads seeded as in the encoder,
# printing the launches, wall seconds, peak memory and one sha256 per
# float32 reconstruction as the last line.
DECODE_IN_A_NEW_PROCESS = """
import hashlib, importlib, json, sys, time
import torch
import chip_smoke
from tpuvc_torch.ops import deform, warp
cli = importlib.import_module("tpuvc_torch.cli." + sys.argv[1])
out = {}
for run in ("cold", "warm"):
    warp.warp_kernel.launches = deform.deform_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with chip_smoke.cli_heads_seeded():
        rec = cli.main(sys.argv[2:])
    out[run] = {
        "main_s": time.perf_counter() - t0,
        "launches": {"warp": warp.warp_kernel.launches,
                     "deform": deform.deform_kernel.launches},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "sha256": {i: hashlib.sha256(t.numpy().tobytes()).hexdigest() for i, t in rec.items()},
    }
print(json.dumps(out))
"""


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


def sequence_cli(torch, runs, intra: bool = True) -> list[dict]:
    """For each of ``runs`` (SEQUENCE_RUNS' form): encode_v in this process
    (a warm-up call, then a timed one with the launch counts set to 0 just
    before and read just after), decode_v on the file in a fresh process
    (DECODE_IN_A_NEW_PROCESS), whose per-frame sha256 must equal the
    encoder's; then, with ``intra``, ELIC alone at batch 3 on the window's
    three anchors. The zero-initialised heads of SEEDED_FAMILIES are seeded
    in both processes (cli_heads_seeded): the run fails unless their flows
    and offsets are fractional."""
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
            bit_exact = all(dec[r]["sha256"] == enc_hashes for r in ("cold", "warm"))
            enc_s = cli_seconds(log.getvalue(), "wrote")
            dec_s = cli_seconds(proc.stdout, "decoded")
            png_s = cli_seconds(proc.stdout, "wrote")
            n_i = sum(1 for t, _, _ in seq.frames if t == "I")
            launches = {k: enc_launches[k] + dec["warm"]["launches"][k] for k in enc_launches}
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
                "decode_main_s": dec["warm"]["main_s"],
                "decode_cold_process_main_s": dec["cold"]["main_s"],
                "bytes": len(blob), "bpp": 8 * len(blob) / (n * h * w), "psnr_db": psnr,
                "decode_bit_exact": bit_exact, "decoder": "separate process",
                "finite": finite, "launches": launches,
                "launches_encode": enc_launches,
                "launches_decode": dec["warm"]["launches"],
                "peak_mem_gib_encode": enc_peak,
                "peak_mem_gib_decode": dec["warm"]["peak_mem_gib"],
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
                if enc_launches[k] == 0 or dec["warm"]["launches"][k] == 0:
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


# sequence_cli_dmc's encode_p run: an I-frame and 16 P-frames, each P-frame's
# down ratio searched over encode_p's default candidates (1.0, 1.25, 1.5,
# 2.0, 3.0, 4.0), q=0, float32 (encode_p has no dtype policy).
SEQUENCE_DMC = ["--synthetic", str(GOP + 1), "--adaptive"]


def release_cache(torch) -> float:
    """Hand this process's cached device memory back to the card, so that a
    subprocess has it; returns the GiB still reserved."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**30


def sequence_cli_dmc(torch) -> dict:
    """encode_p as a user runs it, timed, with the launch counts set to 0
    just before and read just after (no warm-up call: main_path_dmc ran the
    same model and shapes in this process), decode_p on the file in a fresh
    process (DECODE_IN_A_NEW_PROCESS), whose per-frame sha256 must equal the
    encoder's; then ELIC alone at batch 1 (the I-frame of a P sequence),
    float32."""
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
        proc = subprocess.run(
            [sys.executable, "-c", DECODE_IN_A_NEW_PROCESS, "decode_p", "--bin", bin_path,
             "--out_dir", os.path.join(tmp, "png"), *SEQUENCE_MODEL],
            cwd=root, capture_output=True, text=True, timeout=420,
        )
        if proc.returncode != 0:
            raise AssertionError(f"decode_p failed:\n{proc.stderr[-4000:]}")
        dec = json.loads(proc.stdout.strip().splitlines()[-1])
    bit_exact = all(dec[r]["sha256"] == enc_hashes for r in ("cold", "warm"))
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
        "decode_main_s": dec["warm"]["main_s"],
        "decode_cold_process_main_s": dec["cold"]["main_s"],
        "bytes": len(blob), "bpp": 8 * len(blob) / (n * h * w), "psnr_db": psnr,
        "down_ratios": dict(sorted(collections.Counter(float(r) for r in chosen).items())),
        "decode_bit_exact": bit_exact, "decoder": "separate process", "finite": finite,
        "launches_encode": enc_launches, "launches_decode": dec["warm"]["launches"],
        "launches": {k: enc_launches[k] + dec["warm"]["launches"][k] for k in enc_launches},
        "peak_mem_gib_encode": enc_peak, "peak_mem_gib_decode": dec["warm"]["peak_mem_gib"],
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
    if enc_launches["warp"] == 0 or dec["warm"]["launches"]["warp"] == 0:
        raise AssertionError("sequence_cli_dmc launched no warp kernel")
    return row


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


def build_kernels() -> dict:
    """Build the CUDA kernels (one nvcc each, all started together) and the
    rANS library; returns the seconds each took."""
    from tpuvc_torch.coder import rans
    from tpuvc_torch.ops import deform, warp

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    builds = {"warp_s": warp.build_kernel, "deform_s": deform.build_kernel,
              "rans_s": rans.build}
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
    with phase("deform_check", 360):
        deform_rows = deform_check(torch)
    with phase("reference_check", 120):
        reference_check(torch)
    with phase("reference_check_v4", 120):
        reference_check_v4(torch)
    with phase("reference_check_v3", 120):
        reference_check_v3(torch)
    with phase("reference_check_flexrate", 120):
        reference_check_flexrate(torch)
    with phase("main_path", 300):
        lhbdc = main_path(torch)
    with phase("main_path_v4", 420):
        v4 = main_path_v4(torch)
    with phase("main_path_v3", 300):
        v3 = main_path_v3(torch)
    with phase("main_path_flexrate", 300):
        flexrate = main_path_flexrate(torch)
    with phase("sequence_cli", 600):
        seq_rows = sequence_cli(torch, SEQUENCE_RUNS)
    with phase("sequence_cli_v3_flexrate", 420):
        seq_rows += sequence_cli(torch, SEQUENCE_RUNS_V3_FLEXRATE, intra=False)
    with phase("eval_cli", 300):
        eval_rows = eval_cli(torch, EVAL_RUNS)
    with phase("eval_cli_v3_flexrate", 300):
        eval_rows += eval_cli(torch, EVAL_RUNS_V3_FLEXRATE)
    with phase("reference_check_dmc", 120):
        reference_check_dmc(torch)
    with phase("main_path_dmc", 300):
        dmc = main_path_dmc(torch)
    with phase("sequence_cli_dmc", 300):
        seq_dmc = sequence_cli_dmc(torch)
    with phase("eval_cli_dmc", 240):
        eval_rows += eval_cli(torch, EVAL_RUNS_DMC, warm=False)
    with phase("adaptive_ratios", 180):
        adaptive = adaptive_ratios(torch)
    with phase("bench_torch", 480):
        bench = bench_torch_run(torch)
    with phase("path_shapes_check", 180):
        path_rows = path_shapes_check(torch, logged, warp_rows, deform_rows)

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
        paths["adaptive_ratios"] = adaptive["launches"][kernel]
        # bench_torch.py zeroes its counts before its timed coding windows
        # and again before its timed eval passes
        paths["bench_torch"] = bench["record"]["launches"][kernel]
        paths["bench_torch_eval"] = bench["record"]["eval_launches"][kernel]
        return paths

    warp_head = warp_rows[0]  # the largest shape: SPyNet's finest level
    # The deform kernel's headline: the v4 path's largest level, smooth offsets.
    deform_head = next(r for r in deform_rows if r["level"] == "L1" and r["x_shape"][0] == 2
                       and r["spread"] == "smooth_5px")
    # Each kernel on the v3 and Flex-Rate paths: Flex-Rate's warp at B=1 and
    # DeformB's largest level (smooth offsets, the <V=4, MAXO=8> instance).
    slice_heads = {
        "warp": next(r for r in warp_rows if r["compat"] == "flexrate" and r["shape"][0] == 1),
        "deform": next(r for r in deform_rows if r["level"] == "v3 L1"
                       and r["x_shape"][0] == 2 and r["spread"] == "smooth_5px"),
    }
    # The warp on the DMC path: its 48-channel feature warp at 1088x1920.
    dmc_head = next(r for r in warp_rows if r["shape"] == [1, 1088, 1920, 48])
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
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
