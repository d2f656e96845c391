#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: bench.py's 1080p GOP-16 B-frame
enc+dec throughput, computed by tpuvc_torch on one CUDA card.

    python bench_torch.py                                   # on the card
    TPUVC_BENCH_HW=64x64 python bench_torch.py --device cpu  # plumbing only

It runs bench.py's measurement on the port: LHBDC(N=128) with seeded
weights codes a 2-GOP window of GOP-16 1088x1920 B-frames between source
anchors to real rANS streams at batch 4 (level 1 padded to 4), rate 845,
under the bfloat16 layer policy, then decodes the streams; every decode
must equal its encoder's reconstructions bit for bit. fps counts each real
B-frame once through encode and once through decode:
fps = 2 * frames / (t_enc + t_dec). After a warm window, two windows are
timed. Then the ``eval_fps`` extra: the likelihood (eval) forward over the
same window through ``tpuvc_torch.gop.scheduler.code_gops_batched`` at
``max_batch=8``, bf16, under ``torch.inference_mode``, one warm pass and up
to two timed ones (the second while the budget lasts). A budget with less
than 120 s left for the eval, or an error in it, fails the run (exit code
not 0).

Every line is one JSON object. The first names the device (and on a card
its ``nvidia-smi`` name and power limit); each later line is a complete
record with bench.py's keys, the last one the fullest. ``launches`` counts
the kernel launches of the timed coding windows, ``eval_launches`` those of
the timed eval passes. Environment, as for bench.py:
``TPUVC_BENCH_BUDGET_S`` (wall-clock budget, default 540 s),
``TPUVC_BENCH_DTYPE`` (coding policy, default bfloat16), ``TPUVC_BENCH_HW``
(frame size override, e.g. 64x64). ``--device`` defaults to ``cuda``; there
is no quiet fallback to the CPU.

``stream_bpp_random_init_smoke`` comes from seeded random weights: a check
of the stream plumbing, not an RD number.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import time

#: bench.py's CPU anchor (its docstring: a PyTorch-CPU LHBDC eval forward
#: at 1088x1920, measured single-threaded by scripts/torch_anchor.py, and
#: its many-core extrapolation); kept so ``vs_baseline`` means what it
#: means in bench.py's record.
ANCHOR_CPU_FPS = 0.1
ANCHOR_MEASURED_1THREAD_FPS = 0.0109

BUDGET_S = float(os.environ.get("TPUVC_BENCH_BUDGET_S", "540"))


def emit(payload) -> None:
    print(json.dumps(payload), flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0]


def bench_window(torch, coder, h=1088, w=1920, gop=16, G=2, B=4, family="lhbdc"):
    """bench.py's window on the port: a G-GOP window of GOP-``gop`` frames
    from a seed, B-frames between source anchors, every hierarchy level cut
    into batch-B chunks (the last chunk of a level padded by repetition).
    ``family`` "lhbdc" codes each chunk at rate 845 and "flexrate" at
    (n, l) = (1, 1.0), both decoding with the streams submitted ahead;
    "flowguided_b" codes at s=1.0 with the chunk's temporal scales and
    down_ratio 1 (scripts/bench_families.py's v4 window) and "deform_b" at
    s=1.0, both decoding chunk by chunk.
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
        if family == "flexrate":
            return coder.encode_level_batch_async(xb, xc, xa, n=1, l=1.0)
        if family == "deform_b":
            return coder.encode_level_batch_async(xb, xa, xc, s=1.0)
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
            if not hasattr(coder, "decode_level_batch_async"):
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    def remaining():
        return BUDGET_S - (time.perf_counter() - t_start)

    import torch

    from tpuvc_torch import resolve_device
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.gop.order import gop_coding_table
    from tpuvc_torch.gop.scheduler import code_gops_batched
    from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder
    from tpuvc_torch.ops import deform, epilogue, warp
    from tpuvc_torch.ops.precision import mixed_precision, policy_from_name, set_deterministic

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    card = torch.cuda.get_device_name(device) if on_card else "cpu"
    emit({"status": "warming", "budget_s": BUDGET_S, "device": card,
          "nvidia_smi": nvidia_smi() if on_card else None})
    set_deterministic(device)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def peak_gib():
        return torch.cuda.max_memory_allocated(device) / 2**30 if on_card else None

    bench_dtype = os.environ.get("TPUVC_BENCH_DTYPE", "bfloat16")
    h, w = 1088, 1920  # 1080p padded to x64
    if os.environ.get("TPUVC_BENCH_HW"):
        h, w = (int(s) for s in os.environ["TPUVC_BENCH_HW"].split("x"))
    gop, G, B = 16, 2, 4  # a 2-GOP window: level widths 2/4/8/16, batch-4 chunks
    model = LHBDC(N=128, generator=torch.Generator().manual_seed(0))
    coder = LHBDCCoder(model, device=device)
    code_window, decode_window, slot, n_real = bench_window(torch, coder, h, w, gop, G, B)

    def coded_window():
        """Encode then decode one window: (t_enc, t_dec, bytes, bit_exact)."""
        sync()
        t0 = time.perf_counter()
        bits, recons = code_window()
        sync()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        dec = decode_window(bits)
        sync()
        t_dec = time.perf_counter() - t0
        exact = all(torch.equal(dec[f], recons[f]) for f in recons)
        return t_enc, t_dec, sum(b.num_bytes for b in bits.values()), exact

    def zero_launches():
        warp.warp_kernel.launches = deform.deform_kernel.launches = 0
        epilogue.epilogue_kernel.launches = 0

    def read_launches():
        return {"warp": warp.warp_kernel.launches, "deform": deform.deform_kernel.launches,
                "epilogue": epilogue.epilogue_kernel.launches}

    def payload(t_enc, t_dec, nwin, total_bytes, extra=None):
        encdec_fps = 2 * nwin * n_real / (t_enc + t_dec)
        out = {
            "metric": "lhbdc_1080p_gop16_encdec_fps",
            "value": round(encdec_fps, 3),
            "unit": "B-frames/s/chip",
            "vs_baseline": round(encdec_fps / ANCHOR_CPU_FPS, 2),
            "encode_fps": round(nwin * n_real / t_enc, 3),
            "decode_fps": round(nwin * n_real / t_dec, 3),
            "stream_bpp_random_init_smoke": round(
                8 * total_bytes / (nwin * n_real * h * w), 4
            ),
            "decode_bit_exact": bit_exact,
            "measured_windows": nwin,
            "padded_compute_pct": round(100 * 2 / (n_real + 2), 2),
            "warmup_s": round(warm_s, 1),
            "compute_dtype": bench_dtype,
            "anchor_cpu_fps": ANCHOR_CPU_FPS,
            "anchor_measured_1thread_fps": ANCHOR_MEASURED_1THREAD_FPS,
            "device": card,
            "frame": [h, w],
            "peak_mem_gib": coding_peak_gib,
            "launches": coding_launches,
        }
        out.update(extra or {})
        return out

    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        with policy_from_name(bench_dtype):
            _, _, _, bit_exact = coded_window()  # warm: cuDNN, allocator, pools
            if not bit_exact:
                raise AssertionError("decode does not reproduce the encoder's reconstructions")
            warm_s = time.perf_counter() - t_start

            # --- two timed windows, a record after each; ``launches`` counts
            # the kernel launches of the timed windows alone
            zero_launches()
            t_enc = t_dec = 0.0
            total_bytes = 0
            for nwin in (1, 2):
                te, td, nbytes, exact = coded_window()
                t_enc, t_dec, total_bytes = t_enc + te, t_dec + td, total_bytes + nbytes
                bit_exact = bit_exact and exact
                coding_peak_gib = peak_gib()
                coding_launches = read_launches()
                emit(payload(t_enc, t_dec, nwin, total_bytes))
                if not bit_exact:
                    raise AssertionError("decode does not reproduce the encoder's reconstructions")
    finally:
        parallel.shutdown()

    # --- eval_fps: the likelihood forward over the same window at
    # max_batch=8 (level widths 2/4/8/16 -> batches 2, 4, 8, 8, 8), bf16;
    # the coding phase's buffers are released first.
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    if remaining() <= 120.0:
        # The record must carry eval_fps: a budget too short for the eval
        # fails the run rather than leaving the metric out.
        emit(payload(t_enc, t_dec, nwin, total_bytes, extra={
            "eval_fps_skipped": f"{remaining():.1f} s of budget left; the eval needs 120"}))
        return 1
    table = gop_coding_table(gop)
    starts = list(range(0, G * gop, gop))
    anchors = {g: slot[g] for g in range(0, G * gop + 1, gop)}

    def inter_fn(r1, r2, xcur, idxs, refs):
        with mixed_precision():
            out = model(r1, xcur, r2, "dequantize")
        return out["x_hat"], out["sizes"]

    with torch.inference_mode():
        code_gops_batched(slot, anchors, table, inter_fn, starts, max_batch=8)  # warm
        # ``eval_launches`` counts the kernel launches of the timed passes alone
        zero_launches()
        ewin, dt, total_bits = 0, 0.0, 0.0
        while ewin < 2 and (ewin == 0 or remaining() > 1.3 * dt / ewin):
            sync()
            t0 = time.perf_counter()
            _, sizes = code_gops_batched(slot, anchors, table, inter_fn, starts, max_batch=8)
            sync()
            dt += time.perf_counter() - t0
            total_bits += sum(sizes.values())
            ewin += 1
    if not total_bits > 0:
        raise AssertionError("the eval forward counted no bits")
    emit(payload(t_enc, t_dec, nwin, total_bytes, extra={
        "eval_fps": round(ewin * n_real / dt, 3), "eval_windows": ewin, "eval_max_batch": 8,
        "eval_peak_mem_gib": peak_gib(), "eval_launches": read_launches()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
