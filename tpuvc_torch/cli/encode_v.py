"""Encode a frame sequence hierarchically (I + dyadic B GOPs) to one file
(port of tpuvc.cli.encode_v).

    python -m tpuvc_torch.cli.encode_v --frames /data/UVG/beauty \
        --n_frames 65 --bin out.tpvb --family lhbdc --gop 16 --l 1626
    python -m tpuvc_torch.cli.encode_v --synthetic 33 --width 1920 \
        --height 1088 --level_batched --max_batch 4 --window_gops 2 \
        --compute_dtype bfloat16 --init random --bin out.tpvb

ELIC intra streams at GOP boundaries, B-frame streams of the chosen family
in the dyadic coding order, all in one VSequenceBitstream file, which
tpuvc_torch.cli.decode_v (or tpuvc's) decodes. The decoder re-derives the
schedule from the header and each frame's reference pair from the same DPB
walk, so the file is self-contained given the weights. The encoder
reconstructs every frame as the decoder will (the same decode path, the
same DPB), so the two cannot drift.

``--mesh N`` shards the level batches over N processes, one device each,
launched by torchrun; rank 0 writes the file, whose header records N:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m tpuvc_torch.cli.encode_v --synthetic 33 --level_batched \
        --max_batch 4 --mesh 2 --init random --bin out.tpvb

Weights: ``--weights`` is the B family's checkpoint directory (as in
encode_b), ``--weights_intra`` the ELIC .msgpack; ``--init random`` draws
seeded weights instead. Runs on ``--device`` (default ``cuda``; no quiet
fallback to the CPU).
"""

from __future__ import annotations

import argparse
import time


def build_parser():
    from tpuvc_torch.cli.encode_b import FAMILIES

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", default=None,
                   help="directory of PNG frames (sorted)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic frames instead of --frames")
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--n_frames", type=int, default=None)
    p.add_argument("--bin", default="out.tpvb")
    p.add_argument("--family", choices=FAMILIES, default="lhbdc")
    p.add_argument("--gop", type=int, default=16)
    # Rate knobs (family-dependent, as in encode_b).
    p.add_argument("--l", type=int, default=1626,
                   help="lhbdc lambda rate point (228|436|845|1626|3141)")
    p.add_argument("--n", type=int, default=0,
                   help="flexrate gain level")
    p.add_argument("--interp", type=float, default=1.0,
                   help="flexrate interpolation factor l in (0, 1]")
    p.add_argument("--s", type=float, default=0.0,
                   help="v3/v4 fractional rate level")
    p.add_argument("--down_ratio", type=int, default=1,
                   help="v4 motion downsampling ratio")
    p.add_argument("--adaptive", action="store_true",
                   help="v4 per-frame down-ratio search (argmax PSNR of the "
                        "flow-only prediction over {1,2,4,8,16}); the ratio "
                        "is recorded in each frame's stream")
    p.add_argument("--level_batched", action="store_true",
                   help="code frames of the same hierarchy level in one "
                        "batched forward (the stream records the mode; "
                        "decode_v replays the same batch shapes)")
    p.add_argument("--max_batch", type=int, default=8,
                   help="per-forward batch cap for --level_batched")
    p.add_argument("--mesh", type=int, default=1,
                   help="shard --level_batched stages over N devices, one "
                        "process each (launch N with python -m "
                        "torch.distributed.run --nproc_per_node N); the "
                        "header records N and decode_v replays it")
    p.add_argument("--dist_backend", default=None,
                   help="torch.distributed backend for --mesh > 1 (default "
                        "nccl on cuda, gloo on the CPU; ranks sharing a card "
                        "need gloo)")
    p.add_argument("--window_gops", type=int, default=1,
                   help="GOPs coded together per window in --level_batched "
                        "mode: the same hierarchy level across the window's "
                        "GOPs shares one forward")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="layer compute policy (tpuvc_torch.ops.precision); "
                        "recorded in the stream header so decode_v runs "
                        "under the same numerics")
    p.add_argument("--weights", default="pretrained_weights")
    p.add_argument("--weights_intra", default="elic.msgpack")
    p.add_argument("--init", choices=["load", "random"], default="load")
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--intra_N", type=int, default=192)
    p.add_argument("--intra_M", type=int, default=320)
    p.add_argument("--intra_groups", default=None,
                   help="comma ints summing to intra_M (default ELIC groups)")
    p.add_argument("--device", default="cuda",
                   help="torch device to code on (default cuda)")
    return p


def join_mesh(mesh_size: int, backend, device_name: str):
    """The mesh a sequence CLI codes over: None for one device (no process
    group), else this launch's ``mesh_size`` processes. Exits, naming both,
    unless the launch's WORLD_SIZE is ``mesh_size``."""
    from tpuvc_torch.parallel.mesh import make_mesh, world_size

    if world_size() != mesh_size:
        raise SystemExit(
            f"the mesh has {mesh_size} device(s) but this launch has WORLD_SIZE="
            f"{world_size()}: run one process per device, python -m "
            f"torch.distributed.run --nproc_per_node {mesh_size}")
    if mesh_size == 1:
        return None
    return make_mesh(mesh_size, backend=backend, device=device_name)


def check_mesh(args) -> None:
    """tpuvc's --mesh refusals: level-batched mode only, and the header's
    uint8 range."""
    if args.mesh != 1 and not args.level_batched:
        raise SystemExit("--mesh requires --level_batched")
    if not 1 <= args.mesh <= 255:
        raise SystemExit(f"--mesh {args.mesh} out of range (header field is uint8, 1..255)")


def build_intra(args, device):
    """ELICCoder with tpuvc's ELIC weights (``--init load``) or seeded ones
    (``--init random``, a torch.Generator seeded with 0)."""
    import torch

    from tpuvc_torch.models.elic import ELIC, ELICCoder

    if args.intra_groups:
        groups = tuple(int(v) for v in args.intra_groups.split(","))
    else:
        groups = (16, 16, 32, 64, 192) if args.intra_M == 320 else None
    kw = {"N": args.intra_N, "M": args.intra_M}
    if groups is not None:
        kw["groups"] = groups
    if args.init == "random":
        intra = ELIC(**kw, generator=torch.Generator().manual_seed(0))
    else:
        from tpuvc_torch.utils.checkpoint import load_checkpoint
        from tpuvc_torch.utils.convert import params_from_jax

        intra = ELIC(**kw)
        state = params_from_jax(load_checkpoint(args.weights_intra))
        intra.load_state_dict(state, strict=True)
    return ELICCoder(intra, device=device)


def load_frames(args):
    if args.synthetic:
        from tpuvc_torch.data.uvg import SyntheticSequence

        return SyntheticSequence(n_frames=args.synthetic, h=args.height, w=args.width)
    from tpuvc_torch.data.uvg import SequenceFrames

    if not args.frames:
        raise SystemExit("need --frames DIR or --synthetic N")
    return SequenceFrames(args.frames, n_frames=args.n_frames)


def to_host(x):
    """Start a copy of a device frame to the host (a view of it on the
    CPU); the caller synchronises before reading it."""
    return x.to("cpu", non_blocking=True)


def finish(recons: dict, device, h: int, w: int) -> dict:
    """Wait for the host copies; -> {display index: (h, w, 3) float32}."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {i: recons[i][:h, :w] for i in sorted(recons)}


def code_b_frame(coder, family, args, ref1, ref2, xcur, idx, o1, o2):
    """Encode one B-frame; returns (bitstream, decoder-identical recon)."""
    if family == "lhbdc":
        return coder.encode_recon(ref1, xcur, ref2, rate_id=args.l)
    if family == "flexrate":
        return coder.encode_recon(ref1, xcur, ref2, n=args.n, l=args.interp)
    if family == "deform_b":
        return coder.encode_recon(ref1, ref2, xcur, s=args.s)
    from tpuvc_torch.models.flowguided_b import get_scales

    s1, s2 = get_scales(idx, o1, o2)
    ratio = args.down_ratio
    if args.adaptive:
        import torch

        from tpuvc_torch.gop.adaptive import best_down_ratio_prediction

        model = coder.model
        with torch.no_grad():
            ratio, _ = best_down_ratio_prediction(
                lambda r: model.prediction_flowonly(ref1, ref2, s1, s2, r), xcur
            )
        print(f"  frame {idx}: down_ratio {ratio}")
    return coder.encode_recon(
        ref1, ref2, xcur, s=args.s, scale1=s1, scale2=s2, down_ratio=ratio,
    )


def _encode_level_batched(args, frames, coder, intra_coder, device, mesh=None) -> dict:
    """Level-batched encoding: frames of one hierarchy level (across the
    window's GOPs) share every device forward. The decoder replays the same
    batch shapes (VSequenceBitstream mode=1), which keeps the entropy
    decode in sync. Over a ``mesh`` each rank codes its rows of every level
    batch (the coder's set_shard), every rank ends each level with all the
    reconstructions, and rank 0 alone writes the file and prints. Returns
    the reconstructions by display index."""
    import torch

    from tpuvc_torch.coder.container import IFrameBitstream, VSequenceBitstream
    from tpuvc_torch.data.uvg import device_frame
    from tpuvc_torch.gop.order import gop_coding_table
    from tpuvc_torch.ops.precision import policy_from_name
    from tpuvc_torch.parallel.mesh import level_batch_sharder

    h, w = frames.size
    n = len(frames)
    gop = args.gop
    if (n - 1) % gop != 0:
        raise SystemExit(
            f"--level_batched needs k*{gop}+1 frames, got {n}; "
            "drop the tail or use the sequential mode"
        )
    table = gop_coding_table(gop)
    if mesh is not None:
        coder.set_shard(level_batch_sharder(mesh))
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    records: list = []
    anchors: dict = {}
    recons: dict = {}
    t0 = time.perf_counter()

    def intra_batch(fresh):
        """Code a window's fresh anchors in one batched forward (the decoder
        groups the consecutive I records and replays the same batch)."""
        xs = torch.cat([device_frame(frames.u8(b), device) for b in fresh])
        out = intra_coder.compress_batch_async(xs)
        dec = torch.clamp(intra_coder.synthesize(out["y_hat"]), 0.0, 1.0)
        for j, (b, (y_strs, z_str)) in enumerate(zip(fresh, out["strings_resolve"]())):
            anchors[b] = dec[j : j + 1]
            recons[b] = to_host(dec[j])
            blob = IFrameBitstream(z_shape=out["shape"], streams=list(y_strs) + [z_str])
            records.append(("I", b, blob.serialize()))

    def encode_chunk(chunk, refs, xb, xa, xc):
        if args.family == "lhbdc":
            return coder.encode_level_batch_async(xb, xc, xa, rate_id=args.l)
        if args.family == "flexrate":
            return coder.encode_level_batch_async(xb, xc, xa, n=args.n, l=args.interp)
        if args.family == "deform_b":
            return coder.encode_level_batch_async(xb, xa, xc, s=args.s)
        from tpuvc_torch.models.flowguided_b import get_scales

        a0, b0 = refs[0]
        s1, s2 = get_scales(chunk[0][1], a0, b0)
        return coder.encode_level_batch_async(
            xb, xa, xc, s=args.s, scale1=s1, scale2=s2, down_ratio=args.down_ratio,
        )

    def code_window(w0):
        """Code one window of up to --window_gops GOPs."""
        starts = list(range(w0, min(w0 + max(1, args.window_gops) * gop, n - 1), gop))
        fresh = [b for b in [w0] + [g + gop for g in starts] if b not in anchors]
        if fresh:
            intra_batch(fresh)
        # Frames before this window can no longer be referenced.
        for k in [k for k in anchors if k < w0]:
            del anchors[k]
        decoded = {}  # absolute index -> device frame
        for g in starts:
            decoded[g] = anchors[g]
            decoded[g + gop] = anchors[g + gop]
        # Host phases drain on workers; each level's streams are resolved
        # right after the NEXT level is dispatched (one level behind), so a
        # rANS error surfaces within a level of its cause and resolved
        # closures release their symbol arrays.
        pending_prev = []  # the previous level's (chunk, resolve)
        for level_frames in table.frames_by_level():
            pending_cur = []
            work = [(g0, f) for f in level_frames for g0 in starts]
            for c0 in range(0, len(work), args.max_batch):
                chunk = work[c0 : c0 + args.max_batch]
                refs = [table.refs[f] for _, f in chunk]
                xb = torch.cat([decoded[g0 + a] for (g0, _), (a, _) in zip(chunk, refs)])
                xa = torch.cat([decoded[g0 + b] for (g0, _), (_, b) in zip(chunk, refs)])
                xc = torch.cat([device_frame(frames.u8(g0 + f), device) for g0, f in chunk])
                resolve, x_hat = encode_chunk(chunk, refs, xb, xa, xc)
                x_hat = torch.clamp(x_hat, 0.0, 1.0)
                for i, (g0, f) in enumerate(chunk):
                    decoded[g0 + f] = x_hat[i : i + 1]
                    recons[g0 + f] = to_host(x_hat[i])
                pending_cur.append((chunk, resolve))
            for chunk, resolve in pending_prev:
                for (g0, f), b in zip(chunk, resolve()):
                    records.append(("B", g0 + f, b.serialize()))
            pending_prev = pending_cur
        for chunk, resolve in pending_prev:
            for (g0, f), b in zip(chunk, resolve()):
                records.append(("B", g0 + f, b.serialize()))
        say(f"window {w0}..{starts[-1] + gop} coded")

    window = max(1, args.window_gops) * gop
    with policy_from_name(args.compute_dtype):
        for w0 in range(0, n - 1, window):
            code_window(w0)

    seq = VSequenceBitstream(
        family=args.family, width=w, height=h, gop=gop, n_frames=n,
        frames=records, mode=1, max_batch=args.max_batch,
        dtype=1 if args.compute_dtype == "bfloat16" else 0,
        window_gops=max(1, args.window_gops), mesh=args.mesh,
    )
    blob = seq.serialize()
    if mesh is None or mesh.rank == 0:
        with open(args.bin, "wb") as f:
            f.write(blob)
    out = finish(recons, device, h, w)
    mesh_note = f", mesh {args.mesh}" if mesh is not None else ""
    say(
        f"wrote {len(blob)} bytes ({n} frames, "
        f"{8 * len(blob) / (h * w * n):.4f} bpp, level-batched{mesh_note}) to "
        f"{args.bin} in {time.perf_counter() - t0:.3f}s"
    )
    return out


def main(argv=None):
    """Encode; returns the reconstructions, {display index: (H, W, 3)
    float32 CPU tensor}, equal to what decode_v gives for the file."""
    args = build_parser().parse_args(argv)

    import torch

    from tpuvc_torch import resolve_device
    from tpuvc_torch.cli.encode_b import load_model, make_coder
    from tpuvc_torch.coder.container import IFrameBitstream, VSequenceBitstream
    from tpuvc_torch.data.uvg import device_frame
    from tpuvc_torch.eval.metrics import psnr_uint8
    from tpuvc_torch.gop.dpb import DecodedPictureBuffer
    from tpuvc_torch.gop.order import sequence_schedule
    from tpuvc_torch.ops.precision import policy_from_name, set_deterministic

    check_mesh(args)
    if args.level_batched and args.adaptive:
        raise SystemExit(
            "--adaptive needs the sequential mode (the per-frame ratio "
            "search breaks level batching); drop one flag"
        )
    device = resolve_device(args.device)
    mesh = join_mesh(args.mesh, args.dist_backend, args.device)
    if mesh is not None:
        device = mesh.device
    set_deterministic()
    frames = load_frames(args)
    h, w = frames.size
    n = len(frames)
    coder = make_coder(args, load_model(args), device)
    intra_coder = build_intra(args, device)

    if args.level_batched:
        try:
            return _encode_level_batched(args, frames, coder, intra_coder, device, mesh)
        finally:
            if mesh is not None:
                mesh.close()

    order, typ = sequence_schedule(args.gop, n)
    dpb = DecodedPictureBuffer()
    blobs: list = []
    recons: dict = {}
    t0 = time.perf_counter()
    with policy_from_name(args.compute_dtype):
        for idx in order:
            x = device_frame(frames.u8(idx), device)
            if typ[idx] == "I":
                out = intra_coder.compress(x)
                dec = intra_coder.synthesize(out["y_hat"])
                blob = IFrameBitstream.from_compress(out).serialize()
            else:
                ref1, ref2, o1, o2 = dpb.select_references(idx)
                # encode_recon reconstructs from the decoder-identical
                # quantized latents: the buffered frame is what decode_v
                # will buffer.
                bits, dec = code_b_frame(coder, args.family, args, ref1, ref2, x, idx, o1, o2)
                blob = bits.serialize()
            dec = torch.clamp(dec, 0.0, 1.0)
            dpb.add(dec, idx)
            recons[idx] = to_host(dec[0])
            blobs.append((idx, typ[idx], blob))
            p = psnr_uint8(dec[:, :h, :w], x[:, :h, :w])
            print(
                f"frame {idx:4d} {typ[idx]} {len(blob)} bytes "
                f"({8 * len(blob) / (h * w):.4f} bpp) psnr {float(p):.2f}"
            )
    seq = VSequenceBitstream(
        family=args.family, width=w, height=h, gop=args.gop, n_frames=n,
        frames=[(t, i, b) for i, t, b in blobs],
        dtype=1 if args.compute_dtype == "bfloat16" else 0,
    )
    blob = seq.serialize()
    with open(args.bin, "wb") as f:
        f.write(blob)
    out = finish(recons, device, h, w)
    print(
        f"wrote {len(blob)} bytes ({n} frames, "
        f"{8 * len(blob) / (h * w * n):.4f} bpp) to {args.bin} "
        f"in {time.perf_counter() - t0:.3f}s"
    )
    return out


if __name__ == "__main__":
    main()
