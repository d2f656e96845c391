"""The model file of the ``deform_b`` configuration: DeformB (v3, feature
channels (32, 64, 96), N=M=128, coded at rate level 1.5) B-frames with ELIC
I-frames. The program side is :mod:`harness.program` with the
configuration's CLI flags; the reference is :mod:`reference.deform_b`."""

from __future__ import annotations

from harness import codec
from reference import deform_b as ref


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
