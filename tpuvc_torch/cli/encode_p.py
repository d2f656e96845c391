"""Encode a frame sequence low-delay (I + chained P-frames) to one file
(port of tpuvc.cli.encode_p).

    python -m tpuvc_torch.cli.encode_p --frames /data/UVG/beauty \
        --n_frames 33 --bin out.tpvs --q 1.0 --adaptive --intra_period 32
    python -m tpuvc_torch.cli.encode_p --synthetic 17 --width 1920 \
        --height 1088 --adaptive --init random --bin out.tpvs

ELIC intra streams for I-frames and DMC streams for P-frames, all in one
PSequenceBitstream file, which tpuvc_torch.cli.decode_p (or tpuvc's)
decodes. With ``--adaptive`` each P-frame's motion down ratio is chosen
from ``--ratios`` by the fractional search with hysteresis (argmax PSNR of
the warp-only prediction, kept at the previous frame's ratio unless beaten
by 0.1 dB); the ratio rides the frame's header. The encoder reconstructs
every frame as the decoder will, so the two cannot drift.

Weights: ``--weights_intra`` / ``--weights_dmc`` are tpuvc's .msgpack
checkpoints; ``--init random`` draws seeded weights instead (a
``torch.Generator`` seeded with 0 for each codec). Runs on ``--device``
(default ``cuda``; no quiet fallback to the CPU).
"""

from __future__ import annotations

import argparse
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", default=None,
                   help="directory of PNG frames (sorted)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic frames instead of --frames")
    p.add_argument("--width", type=int, default=192,
                   help="synthetic frame width")
    p.add_argument("--height", type=int, default=128,
                   help="synthetic frame height")
    p.add_argument("--n_frames", type=int, default=None)
    p.add_argument("--bin", default="out.tpvs")
    p.add_argument("--q", type=float, default=0.0,
                   help="rate level (fractional; gain interpolation)")
    p.add_argument("--ratio", type=float, default=1.0,
                   help="fixed motion down-sampling ratio")
    p.add_argument("--adaptive", action="store_true",
                   help="per-frame fractional ratio search with hysteresis")
    p.add_argument("--ratios", default="1.0,1.25,1.5,2.0,3.0,4.0",
                   help="candidate ratios for --adaptive (the full OJSP grid "
                        "is 1..8.75 step .25)")
    p.add_argument("--intra_period", type=int, default=32)
    p.add_argument("--weights_intra", default="elic.msgpack")
    p.add_argument("--weights_dmc", default="dmc.msgpack")
    p.add_argument("--init", choices=["load", "random"], default="load")
    p.add_argument("--feat", type=int, default=48)
    p.add_argument("--N", type=int, default=64)
    p.add_argument("--intra_N", type=int, default=192)
    p.add_argument("--intra_M", type=int, default=320)
    p.add_argument("--intra_groups", default=None,
                   help="comma ints summing to intra_M (default ELIC groups)")
    p.add_argument("--device", default="cuda",
                   help="torch device to code on (default cuda)")
    return p


def build_codecs(args, device):
    """(ELICCoder, PFrameDMCCoder) on ``device``, with tpuvc's weights
    (``--init load``) or seeded ones (``--init random``)."""
    import torch

    from tpuvc_torch.cli.encode_v import build_intra
    from tpuvc_torch.models.dmc import PFrameDMC, PFrameDMCCoder

    if args.init == "random":
        dmc = PFrameDMC(feat=args.feat, N=args.N, generator=torch.Generator().manual_seed(0))
    else:
        from tpuvc_torch.utils.checkpoint import load_checkpoint
        from tpuvc_torch.utils.convert import params_from_jax

        dmc = PFrameDMC(feat=args.feat, N=args.N)
        dmc.load_state_dict(params_from_jax(load_checkpoint(args.weights_dmc)), strict=True)
    return build_intra(args, device), PFrameDMCCoder(dmc, device=device)


def main(argv=None):
    """Encode; returns the reconstructions, {display index: (H, W, 3)
    float32 CPU tensor}, equal to what decode_p gives for the file."""
    args = build_parser().parse_args(argv)

    import torch

    from tpuvc_torch import resolve_device
    from tpuvc_torch.cli.encode_v import finish, load_frames, to_host
    from tpuvc_torch.coder.container import IFrameBitstream, PSequenceBitstream
    from tpuvc_torch.data.uvg import device_frame
    from tpuvc_torch.gop.adaptive import fractional_ratio_search
    from tpuvc_torch.ops.precision import set_deterministic

    device = resolve_device(args.device)
    set_deterministic(device)
    frames = load_frames(args)
    h, w = frames.size
    intra_coder, p_coder = build_codecs(args, device)
    model = p_coder.model
    ratios = tuple(float(r) for r in args.ratios.split(","))

    seq = PSequenceBitstream(width=w, height=h)
    dpb = None
    entries: list = []  # (type, blob | Future[PFrameBitstream])
    recons: dict = {}
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            for i in range(len(frames)):
                x = device_frame(frames.u8(i), device)
                if i % args.intra_period == 0:
                    out = intra_coder.compress(x)
                    dec = torch.clamp(intra_coder.synthesize(out["y_hat"]), 0.0, 1.0)
                    entries.append(("I", IFrameBitstream.from_compress(out).serialize()))
                    dpb = {"ref_frame": dec, "ref_feature": None, "ref_down_ratio": 1.0}
                    ratio = 1.0
                else:
                    if args.adaptive:
                        ratio, _, _ = fractional_ratio_search(
                            lambda r: model.warp_prediction(x, dpb["ref_frame"], r), x,
                            prev_ratio=dpb["ref_down_ratio"], ratios=ratios,
                        )
                    else:
                        ratio = args.ratio
                    # The DPB comes back at once; host rANS packs the stream
                    # on a worker, overlapping the next frame's transforms.
                    # Each pending future holds its frame's symbols on the
                    # device, so at most 4 may be pending.
                    pending = [f for _, f in entries if not isinstance(f, bytes)]
                    if len([f for f in pending if not f.done()]) >= 4:
                        pending[-4].result()
                    fut, dpb = p_coder.encode_async(x, dpb, ratio=ratio, q=args.q)
                    entries.append(("P", fut))
                recons[i] = to_host(dpb["ref_frame"][0])
                print(f"frame {i:4d} {entries[-1][0]} ratio {ratio}")
        for typ, item in entries:
            seq.frames.append((typ, item if isinstance(item, bytes) else item.result().serialize()))
    finally:
        p_coder.close()
    for i, (typ, blob) in enumerate(seq.frames):
        print(f"frame {i:4d} {typ} {len(blob)} bytes ({8 * len(blob) / (h * w):.4f} bpp)")
    blob = seq.serialize()
    with open(args.bin, "wb") as f:
        f.write(blob)
    out = finish(recons, device, h, w)
    print(
        f"wrote {len(blob)} bytes ({len(frames)} frames, "
        f"{8 * len(blob) / (h * w * len(frames)):.4f} bpp) to {args.bin} "
        f"in {time.perf_counter() - t0:.3f}s"
    )
    return out


if __name__ == "__main__":
    main()
