"""The model file of the ``lhbdc`` configuration: LHBDC (N=128) B-frames with
ELIC I-frames. The program side is :mod:`harness.program` with the
configuration's CLI flags; the reference is :mod:`reference.lhbdc`."""

from __future__ import annotations

from harness import codec
from reference import lhbdc as ref


def reference(cfg: dict, seed: int, device) -> dict:
    return codec.reference_models(ref, cfg, seed, device, heads=cfg["heads"])


def reference_fns(models: dict, cfg: dict, semantics: str):
    return codec.frame_fns(ref, models, cfg, semantics)


def pieces(cfg: dict, mix: dict) -> dict:
    return codec.pieces(ref, cfg, mix)


def assemble(model, calls: dict):
    return ref.assemble(model, calls)


def follow(model, entry: dict, calls: dict, refs: dict, cfg: dict, semantics: str):
    return ref.follow(model, entry, calls, refs, cfg, semantics)
