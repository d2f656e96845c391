#!/usr/bin/env python3
"""Smoke run of the tpuvc_torch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

It builds the port's kernels from the sources in the checkout, holds each
against its plain PyTorch version at the shapes the paths give it, and
drives two paths once each, both with seeded weights: LHBDC(N=128) codes a
GOP-16, 2-GOP window of 1088x1920 B-frames at batch 4 to real rANS streams,
and FlowGuidedB (v4, full width) codes the same window at batch 2; each
decode must reproduce its encoder's reconstructions bit for bit. Each phase
runs under its own time limit and prints one JSON line:

  device             card name, power limit, software versions
  build              warp and deform kernels (nvcc, in parallel) and rANS
                     library (g++) build times
  warp_check         kernel vs warp_plain per shape: max abs error (<= 1e-5)
                     and bit for bit,
                     kernel / plain / F.grid_sample times, byte bound
  deform_check       kernel vs deform_plain at the v4 path's three shapes and
                     three offset spreads: max abs error (<= 2e-5), kernel /
                     plain times, byte and operation bounds; at the largest
                     shape and spread, two launches must give the same bits
  reference_check    small LHBDC forward on the card vs the same on the CPU
  reference_check_v4 small full-width FlowGuidedB forward, card vs CPU
  main_path          LHBDC: B-frames/s, bpp, PSNR, decode_bit_exact, warp
                     launches, peak device memory
  main_path_v4       FlowGuidedB: the same, with deform launches and the
                     offset spread it measured

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
# context-warp width at an unaligned size, and one zero-padded warp.
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
]

# The coded window: bench.py's frame size and GOP, two GOPs.
FRAME, GOP, WINDOW_GOPS = (1088, 1920), 16, 2

# FlowGuidedB's deform convs at B=2, 1088x1920: (level, x shape, output
# channels, tanh bound of its offsets in px). 16 groups, 3x3 taps.
DEFORM_SHAPES = [
    ("L1", (2, 544, 960, 128), 64, 40.0),
    ("L2", (2, 272, 480, 192), 96, 20.0),
    ("L3", (2, 136, 240, 256), 128, 10.0),
]
DEFORM_GROUPS, DEFORM_TAPS = 16, 9


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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0]


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


def deform_check(torch) -> list[dict]:
    """The deform kernel against deform_plain at the v4 path's three shapes,
    with offsets at three spreads: 0 (integer taps), smooth +-5 px, and
    the level's tanh bound (40/20/10 px: many samples leave the frame)."""
    import torch.nn.functional as F

    from tpuvc_torch.ops import deform as D

    gen = torch.Generator(device="cuda").manual_seed(1)
    G, T = DEFORM_GROUPS, DEFORM_TAPS
    rows = []
    for level, (B, H, W, C), C_out, bound in DEFORM_SHAPES:
        Cg, Og = C // G, C_out // G
        x = torch.randn((B, H, W, C), generator=gen, device="cuda")
        masks = torch.rand((B, H, W, G * T), generator=gen, device="cuda")
        weight = torch.randn((C_out, Cg, 3, 3), generator=gen, device="cuda") / (T * Cg) ** 0.5
        bias = 0.1 * torch.randn((C_out,), generator=gen, device="cuda")
        coarse = torch.rand((B, G * T * 2, H // 16, W // 16), generator=gen, device="cuda")
        spreads = {
            "zero": torch.zeros((B, H, W, G * T * 2), device="cuda"),
            "smooth_5px": (10.0 * F.interpolate(coarse, size=(H, W), mode="bilinear") - 5.0)
            .permute(0, 2, 3, 1).contiguous(),
            f"tanh_{bound:g}px": bound * torch.tanh(
                2.0 * torch.randn((B, H, W, G * T * 2), generator=gen, device="cuda")
            ),
        }
        del coarse
        n_bytes = 4 * (x.numel() + spreads["zero"].numel() + masks.numel()
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
            if spread.startswith("tanh") and level == "L1":
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


def seed_zero_heads(model, generator, flow_scale=1.0, offset_scale=0.05):
    """Give FlowGuidedB's zero-initialised heads seeded weights.

    FlowNET's flow head and Offset_ELIC's offset heads start at zero, so
    with seeded weights every flow would be 0, every offset an integer tap
    and every mask 0.5: the deform kernel's blend and the decoder's
    agreement on fractional samples would go untested. Their final convs get
    flax's lecun-normal draw (the offset heads' scaled down), which gives
    flows and offsets a fractional spread of a few pixels at full width."""
    from tpuvc_torch.models.layers import lecun_normal_

    heads = [(model.flow_estimator.SubpelConv_3.Conv_0, flow_scale)] + [
        (getattr(model.offset_compressor, g).Conv_1, offset_scale)
        for g in ("g_o1", "g_o2", "g_o3")
    ]
    for conv, scale in heads:
        lecun_normal_(conv.weight, generator)
        conv.weight.data.mul_(scale)
    return model


def v4_model(torch, N=128, seed=0, **kw):
    """FlowGuidedB at the repo's v4 widths (feature_channels (64, 96, 128),
    N=M=128, 5 levels, groups (6, 6, 12, 24, 80)), seeded weights, seeded
    heads."""
    from tpuvc_torch.models.flowguided_b import FlowGuidedB

    model = FlowGuidedB(N=N, M=N, generator=torch.Generator().manual_seed(seed), **kw)
    return seed_zero_heads(model, torch.Generator().manual_seed(seed + 1))


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


def reference_check_v4(torch) -> dict:
    """A small full-width FlowGuidedB forward on the card (warp and deform
    kernels, cuDNN, float32 with TF32 off) against the same model on the
    CPU (plain versions)."""
    model = v4_model(torch, seed=3).eval()
    g = torch.Generator().manual_seed(4)
    x1, xc, x2 = (torch.rand((1, 128, 128, 3), generator=g) for _ in range(3))
    with torch.no_grad():
        ref = model(x1, x2, xc, 1.0, 0.5, 0.5, 1, "dequantize")
        model.cuda()
        out = model(x1.cuda(), x2.cuda(), xc.cuda(), 1.0, 0.5, 0.5, 1, "dequantize")
    diff = (out["x_hat"].cpu() - ref["x_hat"]).abs()
    x_err = float(diff.max())
    scale = float(ref["x_hat"].abs().max())
    bits_rel = abs(float(out["size"]) - float(ref["size"])) / float(ref["size"])
    row = {"phase": "reference_check_v4", "shape": [1, 128, 128, 3],
           "model": "FlowGuidedB full width", "x_hat_max_abs_err": x_err,
           "x_hat_max_abs": scale, "bits_rel_err": bits_rel}
    emit(row)
    if not (x_err <= 1e-4 * max(1.0, scale) and bits_rel <= 1e-5):
        raise AssertionError(f"card vs CPU v4 forward disagrees: {row}")
    return row


def bench_window(torch, coder, h=1088, w=1920, gop=16, G=2, B=4, family="lhbdc"):
    """bench.py's window on the port: a G-GOP window of GOP-``gop`` frames
    from a seed, B-frames between source anchors, every hierarchy level cut
    into batch-B chunks (the last chunk of a level padded by repetition).
    ``family`` "lhbdc" codes each chunk at rate 845 and decodes with the
    streams submitted ahead; "flowguided_b" codes at s=1.0 with the chunk's
    temporal scales and down_ratio 1 (scripts/bench_families.py's v4
    window) and decodes chunk by chunk.
    Returns (code_window, decode_window, slot, n_real): code_window() ->
    (streams, reconstructions) by frame index; decode_window(streams) ->
    reconstructions; slot[f] is source frame f."""
    import numpy as np

    from tpuvc_torch.gop.order import gop_coding_table
    from tpuvc_torch.models.flowguided_b import get_scales

    rng = np.random.default_rng(0)
    base = rng.random((h, w, 3), dtype=np.float32)
    drift = (0.01 * rng.standard_normal((h, w, 3))).astype(np.float32)
    frames = [
        torch.from_numpy(np.clip(base + i * drift, 0, 1))[None].to(coder.device)
        for i in range(gop + 1)
    ]
    table = gop_coding_table(gop)
    starts = list(range(0, G * gop, gop))
    slot = [frames[i if i <= gop else i - gop] for i in range(G * gop + 1)]
    anchors = {g: slot[g] for g in range(0, G * gop + 1, gop)}
    levels = [[g + f for g in starts for f in lv] for lv in table.frames_by_level()]

    def chunks(abs_frames):
        for c0 in range(0, len(abs_frames), B):
            chunk = abs_frames[c0 : c0 + B]
            yield chunk + [chunk[-1]] * (B - len(chunk)), len(chunk)

    def refs_of(f):
        g = (f // gop) * gop
        a, b = table.refs[f - g]
        return g + a, g + b

    def encode(xb, xc, xa, f0):
        if family == "lhbdc":
            return coder.encode_level_batch_async(xb, xc, xa, rate_id=845)
        s1, s2 = get_scales(f0, *refs_of(f0))
        return coder.encode_level_batch_async(
            xb, xa, xc, s=1.0, scale1=s1, scale2=s2, down_ratio=1
        )

    def reparse(bits):
        return type(bits).deserialize(bits.serialize())

    def code_window():
        decoded = dict(anchors)
        pending = []
        for abs_frames in levels:
            for chunk, nr in chunks(abs_frames):
                refs = [refs_of(f) for f in chunk]
                xb = torch.cat([decoded[a] for a, _ in refs])
                xa = torch.cat([decoded[b] for _, b in refs])
                xc = torch.cat([slot[f] for f in chunk])
                resolve, x_hat = encode(xb, xc, xa, chunk[0])
                for i, f in enumerate(chunk[:nr]):
                    decoded[f] = x_hat[i : i + 1]
                pending.append((chunk[:nr], resolve))
        bits = {}
        for real, resolve in pending:
            bits.update(zip(real, resolve()))
        return bits, {f: decoded[f] for f in bits}

    def decode_window(bits):
        decoded = dict(anchors)
        plan = [c for lv in levels for c in chunks(lv)]
        lookahead, pending, outs = 3, {}, {}
        for i, (chunk, nr) in enumerate(plan):
            refs = [refs_of(f) for f in chunk]
            xb = torch.cat([decoded[a] for a, _ in refs])
            xa = torch.cat([decoded[b] for _, b in refs])
            if family != "lhbdc":
                x_hat = coder.decode_level_batch(xb, xa, [reparse(bits[f]) for f in chunk])
            else:
                for j in range(i, min(i + lookahead + 1, len(plan))):
                    if j not in pending:
                        parsed = [reparse(bits[f]) for f in plan[j][0]]
                        pending[j] = coder.decode_level_batch_async(parsed)
                x_hat = pending.pop(i)(xb, xa)
            for k, f in enumerate(chunk[:nr]):
                decoded[f] = x_hat[k : k + 1]
                outs[f] = decoded[f]
        return outs

    return code_window, decode_window, slot, G * (gop - 1)


def drive_window(torch, coder, phase_name: str, model: str, B: int, family: str,
                 kernels: list[str], dtype: str = "bfloat16",
                 after_warm=None, extra: dict | None = None) -> dict:
    """The window of :func:`bench_window` at full size (FRAME, GOP,
    WINDOW_GOPS), at batch B, encoded then decoded twice: the first window warms
    cuDNN and the allocator, the second is timed. Every launch count is set
    to 0 just before and read just after; each of ``kernels`` must have
    launched, and every decode must equal its encoder's reconstructions.
    ``after_warm`` runs after the warm window's encode; ``extra`` joins the
    printed row."""
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
    down_ratio 1). The warm window's first chunk measures the offsets'
    spread, which must be fractional and nonzero."""
    from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder

    model = v4_model(torch)
    coder = FlowGuidedBCoder(model, device="cuda")
    spread = {}

    def measure(level):
        def hook(mod, args, out):
            off = args[1]
            if level not in spread:
                frac = off - torch.floor(off)
                spread[level] = {
                    "std_px": float(off.std()), "max_abs_px": float(off.abs().max()),
                    "fractional_share": float(((frac > 1e-3) & (frac < 1 - 1e-3)).float().mean()),
                }
        return hook

    hooks = [
        getattr(model, f"offset_diversity_l{i}").DeformConv_0.register_forward_hook(
            measure(f"L{i}")
        )
        for i in (1, 2, 3)
    ]
    row = drive_window(
        torch, coder, "main_path_v4",
        "FlowGuidedB fc (64,96,128) N=M=128 levels 5, seeded weights and heads",
        B=2, family="flowguided_b", kernels=["warp", "deform"],
        after_warm=lambda: [h.remove() for h in hooks],
        extra={"s": 1.0, "down_ratio": 1, "offset_spread": spread},
    )
    if len(spread) != 3 or not all(
        v["fractional_share"] > 0 and v["std_px"] > 0 for v in spread.values()
    ):
        raise AssertionError(f"the v4 path's offsets have no fractional spread: {spread}")
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

    with phase("warp_check", 300):
        warp_rows = warp_check(torch)
    with phase("deform_check", 240):
        deform_rows = deform_check(torch)
    with phase("reference_check", 120):
        reference_check(torch)
    with phase("reference_check_v4", 120):
        reference_check_v4(torch)
    with phase("main_path", 300):
        lhbdc = main_path(torch)
    with phase("main_path_v4", 420):
        v4 = main_path_v4(torch)

    def by_path(kernel):
        return {"lhbdc": lhbdc["launches"][kernel], "flowguided_b": v4["launches"][kernel]}

    warp_head = warp_rows[0]  # the largest shape: SPyNet's finest level
    # The deform kernel's headline: the v4 path's largest level, smooth offsets.
    deform_head = next(r for r in deform_rows if r["level"] == "L1" and r["spread"] == "smooth_5px")
    kernels = []
    for kernel, head, rows, replaces in (
        ("warp", warp_head, warp_rows, "tpuvc/ops/warp_pallas.py:103"),
        ("deform", deform_head, deform_rows, "tpuvc/ops/deform_pallas.py:101"),
    ):
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
        })
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
