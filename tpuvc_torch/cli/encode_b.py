"""Encode one B-frame to a real bitstream (port of tpuvc.cli.encode_b).

    python -m tpuvc_torch.cli.encode_b --ref_1 a.png --ref_2 b.png \
        --current c.png --bin out.bin --l 1626 --weights dir/

Weights are read from ``{weights}/compression_{l}.msgpack`` (LHBDC),
``{weights}/flexrate.msgpack``, ``{weights}/deform_b.msgpack`` or
``{weights}/flowguided_b.msgpack``: tpuvc's flax checkpoints, converted by
``tpuvc_torch.utils.convert.params_from_jax``. ``--init random`` draws
seeded weights instead. Runs on ``--device`` (default ``cuda``; no quiet
fallback to the CPU).
"""

from __future__ import annotations

import argparse
import os

FAMILIES = ["lhbdc", "flexrate", "deform_b", "flowguided_b"]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--family", choices=FAMILIES, default="lhbdc")
    p.add_argument("--ref_1", default="frames/ref_1.png")
    p.add_argument("--ref_2", default="frames/ref_2.png")
    p.add_argument("--current", default="frames/current.png")
    p.add_argument("--bin", default="bits.bin")
    p.add_argument("--l", type=int, default=1626,
                   help="lhbdc: lambda rate point (228|436|845|1626|3141)")
    p.add_argument("--n", type=int, default=0,
                   help="flexrate: gain level index")
    p.add_argument("--interp", type=float, default=1.0,
                   help="flexrate: fractional interpolation l in (0, 1]")
    p.add_argument("--s", type=float, default=0.0,
                   help="deform_b, flowguided_b: rate level (fractional allowed)")
    p.add_argument("--down_ratio", type=int, default=1,
                   help="flowguided_b: motion-adaptive down ratio")
    p.add_argument("--scale1", type=float, default=0.5)
    p.add_argument("--scale2", type=float, default=-0.5)
    p.add_argument("--weights", default="pretrained_weights")
    p.add_argument("--init", choices=["load", "random"], default="load")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="layer compute policy; the decoder must be run "
                        "with the same value (like --l / --n)")
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--device", default="cuda",
                   help="torch device to code on (default cuda)")
    return p


def load_model(args):
    """The family's model with tpuvc's weights (``--init load``) or seeded
    ones (``--init random``, a torch.Generator seeded with 0)."""
    import torch

    if args.family == "lhbdc":
        from tpuvc_torch.models.lhbdc import LHBDC

        ckpt = f"compression_{args.l}.msgpack"
        make = lambda g: LHBDC(N=args.N, generator=g)
    elif args.family == "flexrate":
        from tpuvc_torch.models.flexrate import BidirFlowRef

        ckpt = "flexrate.msgpack"
        make = lambda g: BidirFlowRef(N=args.N, generator=g)
    elif args.family == "deform_b":
        from tpuvc_torch.models.deform_b import DeformB

        ckpt = "deform_b.msgpack"
        make = lambda g: DeformB(generator=g)
    else:
        from tpuvc_torch.models.flowguided_b import FlowGuidedB

        ckpt = "flowguided_b.msgpack"
        make = lambda g: FlowGuidedB(generator=g)
    if args.init == "random":
        return make(torch.Generator().manual_seed(0))
    from tpuvc_torch.utils.checkpoint import load_checkpoint
    from tpuvc_torch.utils.convert import params_from_jax

    model = make(None)
    state = params_from_jax(load_checkpoint(os.path.join(args.weights, ckpt)))
    model.load_state_dict(state, strict=True)
    return model


def make_coder(args, model, device):
    if args.family == "lhbdc":
        from tpuvc_torch.models.lhbdc import LHBDCCoder

        return LHBDCCoder(model, device=device)
    if args.family == "flexrate":
        from tpuvc_torch.models.flexrate import FlexRateCoder

        return FlexRateCoder(model, device=device)
    if args.family == "deform_b":
        from tpuvc_torch.models.deform_b import DeformBCoder

        return DeformBCoder(model, device=device)
    from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder

    return FlowGuidedBCoder(model, device=device)


def main(argv=None):
    """Returns (bitstream, the decoder-identical reconstruction)."""
    args = build_parser().parse_args(argv)

    from tpuvc_torch import resolve_device
    from tpuvc_torch.data.frames import prepare_frame
    from tpuvc_torch.ops.precision import policy_from_name, set_deterministic

    device = resolve_device(args.device)
    set_deterministic(device)
    coder = make_coder(args, load_model(args), device)
    x_before, _ = prepare_frame(args.ref_1)
    x_after, _ = prepare_frame(args.ref_2)
    x_current, _ = prepare_frame(args.current)
    with policy_from_name(args.compute_dtype):
        if args.family == "lhbdc":
            bits, x_hat = coder.encode_recon(x_before, x_current, x_after, rate_id=args.l)
        elif args.family == "flexrate":
            bits, x_hat = coder.encode_recon(x_before, x_current, x_after, n=args.n,
                                             l=args.interp)
        elif args.family == "deform_b":
            bits, x_hat = coder.encode_recon(x_before, x_after, x_current, s=args.s)
        else:
            bits, x_hat = coder.encode_recon(
                x_before, x_after, x_current, s=args.s, scale1=args.scale1,
                scale2=args.scale2, down_ratio=args.down_ratio,
            )
    with open(args.bin, "wb") as f:
        f.write(bits.serialize())
    print(f"wrote {bits.num_bytes} bytes to {args.bin}")
    return bits, x_hat


if __name__ == "__main__":
    main()
