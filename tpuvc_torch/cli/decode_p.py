"""Decode a low-delay coded sequence (PSequenceBitstream) to PNG frames
(port of tpuvc.cli.decode_p).

    python -m tpuvc_torch.cli.decode_p --bin out.tpvs --out_dir /tmp/dec \
        [--frames /data/UVG/beauty]   # originals -> per-frame PSNR

Counterpart of tpuvc_torch.cli.encode_p: I-frames decode through the ELIC
coder, each run of P-frames up to the next I-frame through the DMC coder's
pipelined ``decode_sequence``, chained through the decoded picture buffer.
The reconstructions equal the encoder's bit for bit. The model flags must
match the encoder's.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bin", default="out.tpvs")
    p.add_argument("--out_dir", default="decoded")
    p.add_argument("--frames", default=None,
                   help="optional originals dir for PSNR")
    p.add_argument("--synthetic", type=int, default=0,
                   help="compare against N synthetic frames (same generator "
                        "as encode_p --synthetic)")
    p.add_argument("--weights_intra", default="elic.msgpack")
    p.add_argument("--weights_dmc", default="dmc.msgpack")
    p.add_argument("--init", choices=["load", "random"], default="load")
    p.add_argument("--feat", type=int, default=48)
    p.add_argument("--N", type=int, default=64)
    p.add_argument("--intra_N", type=int, default=192)
    p.add_argument("--intra_M", type=int, default=320)
    p.add_argument("--intra_groups", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda)")
    return p


def main(argv=None):
    """Decode; returns the reconstructions, {display index: (H, W, 3)
    float32 CPU tensor}, equal to what encode_p returned."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from tpuvc_torch import resolve_device
    from tpuvc_torch.cli.encode_p import build_codecs
    from tpuvc_torch.cli.encode_v import finish, to_host
    from tpuvc_torch.coder.container import (
        IFrameBitstream,
        PFrameBitstream,
        PSequenceBitstream,
    )
    from tpuvc_torch.coder.parallel import parallel_map
    from tpuvc_torch.data.frames import float_to_uint8, save_png
    from tpuvc_torch.eval.metrics import psnr_uint8_np
    from tpuvc_torch.ops.precision import set_deterministic

    device = resolve_device(args.device)
    set_deterministic(device)
    with open(args.bin, "rb") as f:
        seq = PSequenceBitstream.deserialize(f.read())
    h, w, n = seq.height, seq.width, len(seq.frames)
    intra_coder, p_coder = build_codecs(args, device)

    originals = None
    if args.frames:
        from tpuvc_torch.data.uvg import SequenceFrames

        originals = SequenceFrames(args.frames, n_frames=n)
    elif args.synthetic:
        from tpuvc_torch.data.uvg import SyntheticSequence

        originals = SyntheticSequence(n_frames=args.synthetic, h=h, w=w)

    dpb = None
    decoded: dict = {}
    run: list = []  # [(display index, PFrameBitstream)] up to the next I

    def flush_run():
        nonlocal dpb
        if run:
            xs, dpb = p_coder.decode_sequence(dpb, [b for _, b in run])
            for (i, _), x in zip(run, xs):
                decoded[i] = to_host(torch.clamp(x[0], 0.0, 1.0))
            run.clear()

    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            for i, (typ, blob) in enumerate(seq.frames):
                if typ == "I":
                    flush_run()
                    bits = IFrameBitstream.deserialize(blob)
                    dec = intra_coder.decompress(bits.to_strings(), bits.z_shape)
                    dec = torch.clamp(dec, 0.0, 1.0)
                    dpb = {"ref_frame": dec, "ref_feature": None, "ref_down_ratio": 1.0}
                    decoded[i] = to_host(dec[0])
                else:
                    run.append((i, PFrameBitstream.deserialize(blob)))
            flush_run()
    finally:
        p_coder.close()
    out = finish(decoded, device, h, w)

    os.makedirs(args.out_dir, exist_ok=True)

    def write(i):
        img = out[i].numpy()
        save_png(os.path.join(args.out_dir, f"frame_{i:05d}.png"), float_to_uint8(img))
        if originals is not None:
            return psnr_uint8_np(originals.u8(i)[0, :h, :w], img)
        return None

    # zlib releases the interpreter lock: the PNGs compress in parallel.
    t_png = time.perf_counter()
    psnrs = parallel_map(write, range(n))
    for i, ((typ, blob), p) in enumerate(zip(seq.frames, psnrs)):
        line = f"frame {i:4d} {typ} ({8 * len(blob) / (h * w):.4f} bpp)"
        print(line if p is None else f"{line} psnr {p:.2f} dB")
    print(f"wrote {n} PNGs to {args.out_dir} in {time.perf_counter() - t_png:.3f}s")
    msg = f"decoded {n} frames to {args.out_dir} in {time.perf_counter() - t0:.3f}s"
    if originals is not None:
        msg += f"; mean psnr {float(np.mean(psnrs)):.2f} dB"
    print(msg)
    return out


if __name__ == "__main__":
    main()
