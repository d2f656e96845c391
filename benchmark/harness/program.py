"""The system under test: ``tpuvc_torch``'s own sequence paths.

- encode: ``cli.encode_v._encode_level_batched`` with encode_v's parser,
  ``cli.encode_b.load_model`` / ``make_coder`` and ELIC's coder, as
  ``encode_v --level_batched`` runs them. The stream is kept in memory (the
  file goes to the null device), so a run writes no streams to disk.
- decode: ``VSequenceBitstream.deserialize`` of those bytes, then
  ``cli.decode_v._decode_level_batched`` under the stream's recorded
  policy, as ``decode_v`` runs it, without writing PNGs.
- eval: ``eval.runner.eval_sequence_batched`` with ``cli.test``'s
  ``build_models``, ``make_intra_fn`` and ``make_batched_inter_fn``.

The models are built on the meta device and take the benchmark's weights
(``load_state_dict(..., assign=True)``), so no host-side initialisation
runs. Each call ends with the device synchronised.
"""

from __future__ import annotations

import os

import torch


class _Captured:
    """Wraps ``container.VSequenceBitstream`` so that the encoder's
    serialized stream is kept (the CLI writes it to ``--bin``)."""

    def __init__(self):
        from tpuvc_torch.coder import container

        base = container.VSequenceBitstream
        if getattr(base, "_bench_capture", None) is None:
            holder = self

            class Keep(base):
                _bench_capture = holder

                def serialize(self_):
                    blob = base.serialize(self_)
                    Keep._bench_capture.blob = blob
                    return blob

            container.VSequenceBitstream = Keep
        else:
            base._bench_capture = self
        self.blob = None


def code_roles(family: str):
    """-> roles(kind, *args): the frame arguments of a drawn call, ELIC's
    ``compress_batch_async(x)`` or the B coder's
    ``encode_level_batch_async``, whose order of the references and the
    current frame is the family's (encode_v's ``encode_chunk``)."""
    current_second = family in ("lhbdc", "flexrate")

    def roles(kind: str, *a, **k) -> dict:
        if kind == "I":
            return {"current": a[0]}
        if current_second:
            return {"before": a[0], "current": a[1], "after": a[2]}
        return {"before": a[0], "after": a[1], "current": a[2]}

    return roles


def eval_roles(kind: str, *a, **k) -> dict:
    """The frame arguments of ``intra_fn(x)`` and ``inter_fn(ref1, ref2,
    x, idxs, refs)``."""
    if kind == "I":
        return {"current": a[0]}
    return {"before": a[0], "after": a[1], "current": a[2]}


def _intra_model(icfg: dict):
    from tpuvc_torch.models.elic import ELIC

    return ELIC(N=icfg["N"], M=icfg["M"], groups=tuple(icfg["groups"]))


class CodeProgram:
    """encode_v / decode_v's level-batched paths of one B family."""

    phases = ("encode", "decode")

    def __init__(self, cfg: dict, mix: dict, weights: dict, device):
        from tpuvc_torch.cli import encode_b, encode_v
        from tpuvc_torch.models.elic import ELICCoder
        from tpuvc_torch.ops.precision import set_deterministic

        code = cfg["code"]
        argv = list(cfg["cli"]) + [
            "--level_batched", "--gop", str(mix["gop"]),
            "--max_batch", str(code["max_batch"]), "--window_gops", str(code["window_gops"]),
            "--compute_dtype", cfg["compute_dtype"], "--init", "random",
            "--width", str(mix["width"]), "--height", str(mix["height"]),
            "--device", str(device), "--bin", os.devnull,
        ]
        self.args = encode_v.build_parser().parse_args(argv)
        self.device = device
        set_deterministic(device)
        with torch.device("meta"):
            model = encode_b.load_model(self.args)
            intra = _intra_model(cfg["intra"])
        model.load_state_dict(weights["inter"], strict=True, assign=True)
        intra.load_state_dict(weights["intra"], strict=True, assign=True)
        self.coder = encode_b.make_coder(self.args, model, device)
        self.intra_coder = ELICCoder(intra, device=device)
        self.capture = _Captured()
        self.cfg = cfg
        self.roles = code_roles(self.args.family)

    def tap_points(self):
        """(the calls to draw from, the modules whose stages are tapped)."""
        return ({"I": (self.intra_coder, "compress_batch_async"),
                 "B": (self.coder, "encode_level_batch_async")},
                {"I": self.intra_coder.module, "B": self.coder.model})

    def encode(self, seq):
        """-> (stream bytes, {display index: (H, W, 3) float32 host frame})."""
        from tpuvc_torch.cli import encode_v

        self.capture.blob = None
        recons = encode_v._encode_level_batched(self.args, seq, self.coder, self.intra_coder,
                                                self.device)
        return self.capture.blob, recons

    def decode(self, blob):
        """-> {display index: (H, W, 3) float32 host frame}."""
        from tpuvc_torch.cli import decode_v, encode_v
        from tpuvc_torch.coder.container import (BFrameBitstream, VFrameBitstream,
                                                 VSequenceBitstream)
        from tpuvc_torch.ops.precision import policy_from_name

        seq = VSequenceBitstream.deserialize(blob)
        frame_cls = BFrameBitstream if seq.family in ("lhbdc", "flexrate") else VFrameBitstream
        with policy_from_name("bfloat16" if seq.dtype == 1 else "float32"):
            decoded = decode_v._decode_level_batched(seq, self.coder, self.intra_coder, frame_cls)
        return encode_v.finish(decoded, self.device, seq.height, seq.width)


class EvalProgram:
    """The RD eval's level-batched path (cli.test with level_batched=true)."""

    phases = ("eval",)

    def __init__(self, cfg: dict, mix: dict, weights: dict, device):
        from tpuvc_torch.cli import test as eval_cli
        from tpuvc_torch.config import TestConfig, apply_overrides
        from tpuvc_torch.ops.precision import set_deterministic

        ev = mix["eval"]
        self.tc = TestConfig()
        apply_overrides(self.tc, list(cfg["eval_overrides"]) + [
            "level_batched=true", "eval_msssim=false", f"dataset.gop={mix['gop']}",
            f"max_batch={ev['max_batch']}", f"window_gops={ev['window_gops']}",
            f"compute_dtype={cfg['compute_dtype']}",
        ])
        self.device = device
        self.level = ev["level"]
        set_deterministic(device)
        with torch.device("meta"):
            intra, model = eval_cli.build_models(self.tc, 0)
        intra.load_state_dict(weights["intra"], strict=True, assign=True)
        model.load_state_dict(weights["inter"], strict=True, assign=True)
        self.intra, self.model = intra.to(device).eval(), model.to(device).eval()
        self.intra_fn = eval_cli.make_intra_fn(self.intra)
        self.inter_fn = eval_cli.make_batched_inter_fn(self.tc, self.model, self.level,
                                                       self.tc.dataset.gop)
        self.kept = None
        self.cfg = cfg
        self.roles = eval_roles

    def tap_points(self):
        """(the calls to draw from, the modules whose stages are tapped)."""
        return ({"I": (self, "intra_fn"), "B": (self, "inter_fn")},
                {"I": self.intra, "B": self.model})

    def eval(self, seq, keep: bool = False):
        """-> (psnr list, size list); with ``keep``, ``self.kept`` holds the
        window's clamped reconstructions {display index: device frame}."""
        from tpuvc_torch.data.uvg import device_frame
        from tpuvc_torch.eval.runner import eval_sequence_batched
        from tpuvc_torch.gop import scheduler
        from tpuvc_torch.ops.precision import policy_from_name

        device = self.device

        class _Device:
            def __getitem__(self, i):
                return device_frame(seq.u8(i), device)

        code = scheduler.code_gops_batched
        kept = {}

        def keeping(*a, **k):
            decoded, sizes = code(*a, **k)
            kept.update(decoded)
            return decoded, sizes

        if keep:
            scheduler.code_gops_batched = keeping
        try:
            with policy_from_name(self.tc.compute_dtype), torch.inference_mode():
                out = eval_sequence_batched(
                    _Device(), len(seq), self.tc.dataset.gop, self.intra_fn, self.inter_fn,
                    crop_hw=tuple(seq.size), level=self.level, max_batch=self.tc.max_batch,
                    window_gops=self.tc.window_gops)
        finally:
            scheduler.code_gops_batched = code
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.kept = kept if keep else None
        return out


PROGRAMS = {"code": CodeProgram, "eval": EvalProgram}
