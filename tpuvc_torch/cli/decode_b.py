"""Decode one B-frame bitstream back to a PNG (port of tpuvc.cli.decode_b).

    python -m tpuvc_torch.cli.decode_b --ref_1 a.png --ref_2 b.png \
        --bin out.bin --out decoded.png --weights dir/

LHBDC's lambda, and so its weights file, and Flex-Rate's (n, l) are read
from the bitstream header.
``--compute_dtype`` and the model flags must match the encoder's.
"""

from __future__ import annotations

import argparse
import os

from tpuvc_torch.cli.encode_b import FAMILIES


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--family", choices=FAMILIES, default="lhbdc")
    p.add_argument("--ref_1", default="frames/ref_1.png")
    p.add_argument("--ref_2", default="frames/ref_2.png")
    p.add_argument("--bin", default="bits.bin")
    p.add_argument("--out", default="decoded.png")
    p.add_argument("--weights", default="pretrained_weights")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="must match the encoder's --compute_dtype")
    p.add_argument("--init", choices=["load", "random"], default="load")
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--current", default=None,
                   help="optional ground-truth frame: prints PSNR and the "
                        "stream size")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda)")
    return p


def main(argv=None):
    """Returns the decoded (1, H', W', 3) frame, padded, unclamped."""
    args = build_parser().parse_args(argv)

    from tpuvc_torch import resolve_device
    from tpuvc_torch.cli.encode_b import load_model, make_coder
    from tpuvc_torch.coder.container import BFrameBitstream, VFrameBitstream
    from tpuvc_torch.data.frames import float_to_uint8, prepare_frame, save_png
    from tpuvc_torch.ops.precision import policy_from_name, set_deterministic

    device = resolve_device(args.device)
    set_deterministic(device)
    with open(args.bin, "rb") as f:
        blob = f.read()
    if args.family in ("lhbdc", "flexrate"):
        bits = BFrameBitstream.deserialize(blob)
        args.l = bits.rate_id  # LHBDC's weights file names its lambda
    else:
        bits = VFrameBitstream.deserialize(blob)
    coder = make_coder(args, load_model(args), device)

    x_before, size = prepare_frame(args.ref_1)
    x_after, _ = prepare_frame(args.ref_2)
    with policy_from_name(args.compute_dtype):
        x_hat = coder.decode(x_before, x_after, bits)
    h, w = size
    img = float_to_uint8(x_hat[0, :h, :w].cpu().numpy())
    save_png(args.out, img)
    print(f"decoded {args.out} ({h}x{w})")
    if args.current is not None:
        from tpuvc_torch.eval.metrics import psnr_uint8_np

        gt, _ = prepare_frame(args.current)
        gt_img = float_to_uint8(gt[0, :h, :w].numpy())
        print(f"psnr {psnr_uint8_np(gt_img, img):.2f} dB, "
              f"{os.path.getsize(args.bin)} bytes")
    return x_hat


if __name__ == "__main__":
    main()
