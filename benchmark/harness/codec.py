"""What the configurations of the hierarchical-B codecs share on the
reference side: their models with the benchmark's weights, the reference's
I- and B-frame functions under the program's semantics, and the pieces
whose work a phase counts. A configuration's model file
(``benchmark/models/<config>.py``) names its reference module and heads."""

from __future__ import annotations

import torch

from . import weights as W


def reference_models(ref, cfg: dict, seed: int, device, heads: dict | None = None) -> dict:
    """{"intra": ELIC, "inter": the B model} of the plain reference, with
    the weights of ``seed`` made on ``device``."""
    from reference.elic import ELIC

    icfg = cfg["intra"]
    intra = W.seeded(lambda: ELIC(N=icfg["N"], M=icfg["M"], groups=tuple(icfg["groups"])),
                     seed, device, stream=0)
    inter = W.seeded(lambda: ref.build(cfg), seed, device, heads=heads, stream=1)
    return {"intra": intra, "inter": inter}


def frame_fns(ref, models: dict, cfg: dict, semantics: str):
    """(intra(x), inter(ref_before, x, ref_after, order, o1, o2)), each
    returning the reconstruction first."""
    intra_m, inter_m = models["intra"], models["inter"]
    intra = intra_m.encode if semantics == "stream" else intra_m.forward_eval

    def inter(xb, xc, xa, order, o1, o2):
        return ref.b_frame(inter_m, xb, xc, xa, order, o1, o2, cfg, semantics)

    return intra, inter


def pieces(ref, cfg: dict, mix: dict) -> dict:
    """{phase: [(fn on meta tensors, times per sequence)]} at the mix's
    frame size, batch 1: ``gop``-spaced anchors are I-frames, the rest
    B-frames (their work does not depend on the frame's place)."""
    from reference.elic import ELIC

    H, W_, n, gop = mix["height"], mix["width"], mix["frames"], mix["gop"]
    n_use = ((n - 1) // gop) * gop + 1
    n_i = (n_use - 1) // gop + 1
    n_b = n_use - n_i
    icfg = cfg["intra"]
    with torch.device("meta"):
        intra = ELIC(N=icfg["N"], M=icfg["M"], groups=tuple(icfg["groups"])).to("meta")
        inter = ref.build(cfg).to("meta")
    x = torch.empty((1, H, W_, 3), device="meta")
    order, o1, o2 = gop // 2, 0, gop

    def i_encode():
        return intra.encode(x)

    def i_decode():
        z = torch.empty((1, H // 64, W_ // 64, icfg["N"]), device="meta")
        return intra.decode_work(z)

    def b_encode():
        return ref.b_frame(inter, x, x, x, order, o1, o2, cfg, "stream")

    latents = ref.b_frame(inter, x, x, x, order, o1, o2, cfg, "stream")[2]

    def b_decode():
        return ref.b_decode(inter, x, x, latents, order, o1, o2, cfg)

    def i_eval():
        return intra.forward_eval(x)

    def b_eval():
        return ref.b_frame(inter, x, x, x, order, o1, o2, cfg, "eval")

    if mix["kind"] == "code":
        return {"encode": [(i_encode, n_i), (b_encode, n_b)],
                "decode": [(i_decode, n_i), (b_decode, n_b)]}
    return {"eval": [(i_eval, n_i), (b_eval, n_b)]}

