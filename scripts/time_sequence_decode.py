#!/usr/bin/env python3
"""Time decode_v on one file several times in one process, frame by frame.

    python3 scripts/time_sequence_decode.py --runs 3 --heads seeded -- \
        --family flowguided_b --synthetic 17 --gop 16 --width 1920 \
        --height 1088 --compute_dtype bfloat16 --s 1.0 --init random

Encodes the sequence once with ``tpuvc_torch.cli.encode_v`` (the arguments
after ``--``), then calls ``decode_v.main`` ``--runs`` times on the file in
this process. Each I and B frame's decode call is timed between two CUDA
synchronisations. ``--heads seeded`` gives FlowGuidedB's flow and offset
heads seeded values in the encoder and every decode
(``chip_smoke.cli_heads_seeded``); ``zero`` leaves them as ``--init
random`` draws them. Prints one JSON line per run: the CLI's decode and PNG
seconds, each frame's decode ms in coding order, and the bytes of each
frame's record. Needs one CUDA card (``--device cuda``, the CLIs' default).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def frame_timer(torch, log: list):
    """Time every coder decode call (CUDA synchronised) into ``log`` as
    (kind, ms) while open."""
    from tpuvc_torch.models.elic import ELICCoder
    from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder
    from tpuvc_torch.models.lhbdc import LHBDCCoder

    patched = [(ELICCoder, "decompress", "I"), (ELICCoder, "decompress_batch", "I"),
               (FlowGuidedBCoder, "decode", "B"), (LHBDCCoder, "decode", "B")]
    originals = [(cls, name, getattr(cls, name)) for cls, name, _ in patched]

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def timed(fn, kind):
        def call(self, *a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            sync()
            log.append((kind, 1e3 * (time.perf_counter() - t0)))
            return out
        return call

    for (cls, name, kind), (_, _, fn) in zip(patched, originals):
        setattr(cls, name, timed(fn, kind))
    try:
        yield
    finally:
        for cls, name, fn in originals:
            setattr(cls, name, fn)


def main() -> int:
    import torch

    import bench_torch
    import chip_smoke
    from tpuvc_torch.cli import decode_v, encode_v
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import VSequenceBitstream

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--heads", choices=["seeded", "zero"], default="seeded")
    p.add_argument("encode_args", nargs=argparse.REMAINDER)
    args = p.parse_args()
    enc_args = [a for a in args.encode_args if a != "--"]
    # the model flags decode_v must share with the encoder
    shared = {"--init", "--device", "--weights", "--weights_intra", "--N", "--intra_N",
              "--intra_M", "--intra_groups"}
    model_flags = [a for i, a in enumerate(enc_args)
                   if a in shared or (i and enc_args[i - 1] in shared)]
    heads = chip_smoke.cli_heads_seeded if args.heads == "seeded" else contextlib.nullcontext
    if torch.cuda.is_available():
        print(bench_torch.nvidia_smi(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        bin_path = os.path.join(tmp, "seq.tpvb")
        try:
            with heads(), contextlib.redirect_stdout(io.StringIO()):
                encode_v.main(enc_args + ["--bin", bin_path])
            seq = VSequenceBitstream.deserialize(open(bin_path, "rb").read())
            for run in range(args.runs):
                log, out = [], io.StringIO()
                with heads(), frame_timer(torch, log), contextlib.redirect_stdout(out):
                    decode_v.main(["--bin", bin_path, "--out_dir", os.path.join(tmp, "png")]
                                  + model_flags)
                text = out.getvalue()
                print(json.dumps({
                    "run": run, "heads": args.heads, "encode_args": enc_args,
                    "decode_s": chip_smoke.cli_seconds(text, "decoded"),
                    "png_s": chip_smoke.cli_seconds(text, "wrote"),
                    "frames": [[t, i, len(b)] for t, i, b in seq.frames],
                    "frame_ms": [[k, round(ms, 2)] for k, ms in log],
                }), flush=True)
        finally:
            parallel.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
