"""Decode a hierarchically coded sequence (VSequenceBitstream) to PNGs (port
of tpuvc.cli.decode_v).

    python -m tpuvc_torch.cli.decode_v --bin out.tpvb --out_dir /tmp/dec \
        [--frames /data/UVG/beauty]   # originals -> per-frame PSNR

Counterpart of tpuvc_torch.cli.encode_v. Frames carry their display index,
so the decoder replays the file's coding order, and the decoded-picture-
buffer walk re-derives every frame's reference pair. I-frames decode
through the ELIC coder, B-frames through the family's coder: the decode
path the encoder used to build its buffer, so the reconstructions equal
the encoder's bit for bit. Streams with header mode=1 were coded with
level-batched forwards and decode through the same batch shapes, under the
compute dtype the header records. The model flags must match the
encoder's.

A stream coded over a mesh (``encode_v --mesh N``, header mesh=N) decodes
under a launch of N processes, each decoding its rows of every level batch
as the encoder's rank did; rank 0 writes the PNGs and prints:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m tpuvc_torch.cli.decode_v --bin out.tpvb --out_dir /tmp/dec
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bin", default="out.tpvb")
    p.add_argument("--out_dir", default="decoded")
    p.add_argument("--frames", default=None,
                   help="optional originals dir for PSNR")
    p.add_argument("--synthetic", type=int, default=0,
                   help="compare against N synthetic frames (same generator "
                        "as encode_v --synthetic)")
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--height", type=int, default=128)
    # Model knobs must match the encoder's (as with encode_b/decode_b).
    p.add_argument("--weights", default="pretrained_weights")
    p.add_argument("--weights_intra", default="elic.msgpack")
    p.add_argument("--init", choices=["load", "random"], default="load")
    p.add_argument("--l", type=int, default=1626)
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--intra_N", type=int, default=192)
    p.add_argument("--intra_M", type=int, default=320)
    p.add_argument("--intra_groups", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda)")
    p.add_argument("--dist_backend", default=None,
                   help="torch.distributed backend for a stream coded over a "
                        "mesh (default nccl on cuda, gloo on the CPU)")
    return p


def _regroup(seq, level_of) -> list:
    """The file's records regrouped into the encoder's batches: runs of
    consecutive I records, and consecutive B records of one window and one
    hierarchy level, at most the header's max_batch a chunk.
    -> [("I" | "B", [(display index, blob), ...]), ...]"""
    gop = seq.gop
    window = max(1, seq.window_gops) * gop
    groups: list = []
    chunk: list = []
    i_run: list = []
    for ftyp, idx, blob in seq.frames:
        if ftyp == "I":
            if chunk:
                groups.append(("B", chunk))
                chunk = []
            i_run.append((idx, blob))
            continue
        if i_run:
            groups.append(("I", i_run))
            i_run = []
        same_chunk = (
            chunk
            and len(chunk) < (seq.max_batch or 8)
            and (idx // window) == (chunk[0][0] // window)
            and level_of[idx - (idx // gop) * gop]
            == level_of[chunk[0][0] - (chunk[0][0] // gop) * gop]
        )
        if not same_chunk:
            if chunk:
                groups.append(("B", chunk))
            chunk = []
        chunk.append((idx, blob))
    if i_run:
        groups.append(("I", i_run))
    if chunk:
        groups.append(("B", chunk))
    return groups


def _decode_level_batched(seq, coder, intra_coder, frame_cls) -> dict:
    """Decode a mode=1 (level-batched) stream through the encoder's batch
    shapes; shape parity keeps the re-estimated flow, and with it the rANS
    decode, bit-identical. Returns host copies of the padded frames by
    display index."""
    import torch

    from tpuvc_torch.cli.encode_v import to_host
    from tpuvc_torch.coder.container import IFrameBitstream
    from tpuvc_torch.gop.order import gop_coding_table

    gop = seq.gop
    window = max(1, seq.window_gops) * gop
    table = gop_coding_table(gop)
    level_of = {f: li for li, lv in enumerate(table.frames_by_level()) for f in lv}
    # Device copies live only while a later frame can reference them (the
    # current window and its boundaries); host copies feed the PNG writer.
    decoded: dict = {}
    decoded_host: dict = {}

    def flush(chunk, resolve=None):
        w0 = (chunk[0][0] // window) * window
        # Frames before this window can no longer be referenced.
        for k in [k for k in decoded if k < w0]:
            del decoded[k]
        gs = [(idx // gop) * gop for idx, _ in chunk]
        refs = [table.refs[idx - g0] for (idx, _), g0 in zip(chunk, gs)]
        xb = torch.cat([decoded[g0 + a] for g0, (a, _) in zip(gs, refs)])
        xa = torch.cat([decoded[g0 + b] for g0, (_, b) in zip(gs, refs)])
        if resolve is None:
            bits = [frame_cls.deserialize(blob) for _, blob in chunk]
            x_hat = coder.decode_level_batch(xb, xa, bits)
        else:
            x_hat = resolve(xb, xa)
        x_hat = torch.clamp(x_hat, 0.0, 1.0)
        for i, (idx, _) in enumerate(chunk):
            decoded[idx] = x_hat[i : i + 1]
            decoded_host[idx] = to_host(x_hat[i])

    def flush_i(i_run):
        """Decode a run of consecutive I records in one batched forward:
        the encoder coded a window's fresh anchors together, so the run
        length is the encoder's batch size."""
        bits = [IFrameBitstream.deserialize(blob) for _, blob in i_run]
        dec = intra_coder.decompress_batch([b.to_strings() for b in bits], bits[0].z_shape)
        dec = torch.clamp(dec, 0.0, 1.0)
        for j, (idx, _) in enumerate(i_run):
            decoded[idx] = dec[j : j + 1]
            decoded_host[idx] = to_host(dec[j])

    groups = _regroup(seq, level_of)
    # LHBDC's and Flex-Rate's entropy decode needs no references: a B
    # chunk's rANS and entropy parameters are submitted up to `lookahead`
    # chunks ahead on workers while the device tail of earlier chunks runs.
    # v3's and v4's conditional bottlenecks need the references for their
    # entropy parameters, so they decode chunk by chunk.
    pipelined = hasattr(coder, "decode_level_batch_async")
    lookahead = 4
    pending: dict = {}

    def submit_ahead(start):
        for j in range(start, min(start + lookahead, len(groups))):
            typ, recs = groups[j]
            if typ == "B" and j not in pending:
                bits = [frame_cls.deserialize(blob) for _, blob in recs]
                pending[j] = coder.decode_level_batch_async(bits)

    for j, (typ, recs) in enumerate(groups):
        if typ == "I":
            flush_i(recs)
        elif pipelined:
            submit_ahead(j)
            flush(recs, pending.pop(j))
        else:
            flush(recs)
    return decoded_host


def main(argv=None):
    """Decode; returns the reconstructions, {display index: (H, W, 3)
    float32 CPU tensor}, equal to what encode_v returned."""
    args = build_parser().parse_args(argv)

    from tpuvc_torch import resolve_device
    from tpuvc_torch.cli.encode_v import join_mesh
    from tpuvc_torch.coder.container import VSequenceBitstream
    from tpuvc_torch.ops.precision import set_deterministic

    device = resolve_device(args.device)
    set_deterministic()
    with open(args.bin, "rb") as f:
        seq = VSequenceBitstream.deserialize(f.read())
    args.family = seq.family
    # The encoder sharded its level batches over seq.mesh processes: replay
    # the same split (the coders' set_shard), or the re-derived entropy
    # parameters would come from other batch shapes.
    if seq.mesh > 1 and seq.mode != 1:
        raise SystemExit(f"a mesh={seq.mesh} stream must be level-batched (mode 1), "
                         f"this one has mode {seq.mode}")
    mesh = join_mesh(seq.mesh, args.dist_backend, args.device)
    try:
        return _decode(args, seq, device if mesh is None else mesh.device, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _decode(args, seq, device, mesh) -> dict:
    """decode_v's body on ``device``, over ``mesh`` (None: one device)."""
    import numpy as np
    import torch

    from tpuvc_torch.cli.encode_b import load_model, make_coder
    from tpuvc_torch.cli.encode_v import build_intra, finish, load_frames, to_host
    from tpuvc_torch.coder.container import BFrameBitstream, IFrameBitstream, VFrameBitstream
    from tpuvc_torch.coder.parallel import parallel_map
    from tpuvc_torch.data.frames import float_to_uint8, save_png
    from tpuvc_torch.eval.metrics import psnr_uint8_np
    from tpuvc_torch.gop.dpb import DecodedPictureBuffer
    from tpuvc_torch.ops.precision import policy_from_name
    from tpuvc_torch.parallel.mesh import level_batch_sharder

    rank0 = mesh is None or mesh.rank == 0
    h, w, n = seq.height, seq.width, seq.n_frames
    coder = make_coder(args, load_model(args), device)
    if mesh is not None:
        coder.set_shard(level_batch_sharder(mesh))
    intra_coder = build_intra(args, device)
    frame_cls = BFrameBitstream if seq.family in ("lhbdc", "flexrate") else VFrameBitstream

    originals = None
    if args.frames or args.synthetic:
        args.n_frames = n
        args.width, args.height = w, h  # the stream header wins
        if args.synthetic:
            args.synthetic = n
        originals = load_frames(args)

    t0 = time.perf_counter()
    # The decoder runs under the encoder's recorded compute policy: the
    # re-derived entropy parameters must match numerically.
    with policy_from_name("bfloat16" if seq.dtype == 1 else "float32"):
        if seq.mode == 1:
            decoded = _decode_level_batched(seq, coder, intra_coder, frame_cls)
        else:
            dpb = DecodedPictureBuffer()
            decoded = {}
            for ftyp, idx, blob in seq.frames:
                if ftyp == "I":
                    bits = IFrameBitstream.deserialize(blob)
                    dec = intra_coder.decompress(bits.to_strings(), bits.z_shape)
                else:
                    ref1, ref2, _, _ = dpb.select_references(idx)
                    dec = coder.decode(ref1, ref2, frame_cls.deserialize(blob))
                dec = torch.clamp(dec, 0.0, 1.0)
                dpb.add(dec, idx)
                decoded[idx] = to_host(dec[0])
                print(f"frame {idx:4d} {ftyp} {len(blob)} bytes")
    out = finish(decoded, device, h, w)
    if not rank0:  # every rank holds the frames; rank 0 writes them
        return out

    os.makedirs(args.out_dir, exist_ok=True)

    def write(i):
        img = out[i].numpy()
        save_png(os.path.join(args.out_dir, f"frame_{i:05d}.png"), float_to_uint8(img))
        if originals is not None:
            return psnr_uint8_np(originals.u8(i)[0, :h, :w], img)
        return None

    # zlib releases the interpreter lock: the PNGs compress in parallel.
    t_png = time.perf_counter()
    psnrs = [p for p in parallel_map(write, range(n)) if p is not None]
    print(f"wrote {n} PNGs to {args.out_dir} in {time.perf_counter() - t_png:.3f}s")
    msg = (f"decoded {n} frames{' (level-batched)' if seq.mode == 1 else ''} to "
           f"{args.out_dir} in {time.perf_counter() - t0:.3f}s")
    if psnrs:
        msg += f"; mean psnr {float(np.mean(psnrs)):.2f} dB"
    print(msg)
    return out


if __name__ == "__main__":
    main()
