"""DeformB (ICIP 2023, ``ICIP2023/src/model/m.py:20``) B-frame codec:
feature-space alignment with no explicit flow. Both references' /2, /4,
/8 feature pyramids (32/64/96 channels) side by side condition a
conditional ELIC bottleneck that codes, per scale and per reference, 144
deform offsets and 72 mask logits; six modulated deformable convolutions
(8 groups, 3x3 taps) align the references' features with them; a second
bottleneck, whose analysis also reads the raw current frame, codes the
feature residues; a reconstructor with transposed convolutions gives the
frame. Both bottlenecks take a continuous rate level s.

Two semantics, as the program has them: the coder's stream path (z around
the medians, checkerboard groups around their means) and the eval's
likelihood pass (contexts and latents rounded plainly).

Plain float32, as every reference pass of the harness runs it: after
:func:`reference.numerics.strict` (TF32 off for matrix products and
convolutions), no kernel of the program, no batching tricks.

Departures from ``m.py``:

- NHWC tensors; the deform convolutions sample with zero padding outside
  the frame (torchvision's), the offsets read as (dy, dx) per (group, tap);
- the weights are the benchmark's seeded draws, not a trained checkpoint;
  the offset heads (zero at the start) get a lecun-normal draw where the
  configuration names them, and every gain vector a draw
  (:mod:`reference.deform_b_parts`), where the published model starts
  them at one;
- the rate level's interpolation exponents are float32 host scalars, and
  the interpolation runs in float32 on the device, as the program does;
- no training path (the published model trains with additive noise).
"""

from __future__ import annotations

import torch
from torch import nn

from . import links as L
from .deform import DeformConv
from .deform_b_parts import GainedCondELIC, PixelCondELIC, ReconstructorDeconv
from .flowguided_b import _bottleneck
from .ms_feature import MSFeature, TemporalEnc

DEFORM_GROUPS = 8
#: each reference's head: 144 offsets (8 groups x 9 taps x (dy, dx)), then
#: 72 mask logits
N_OFFSETS = 144


def head_to_deform(head):
    """One reference's 216 head channels -> (offsets, sigmoid masks)."""
    return head[..., :N_OFFSETS], torch.sigmoid(head[..., N_OFFSETS:])


class DeformB(nn.Module):
    def __init__(self, feature_channels=(32, 64, 96), N: int = 128, M: int = 128,
                 levels: int = 5, groups=(6, 6, 12, 24, 80)):
        super().__init__()
        fc = tuple(feature_channels)
        comp = tuple(2 * c for c in fc)    # both references side by side
        inputs = tuple(3 * c for c in fc)  # [conditions | current frame]
        self.feature_extractor = MSFeature(channels=fc)
        self.offset_temp_encoder = TemporalEnc(comp, N=N, M=M)
        self.offset_compressor = GainedCondELIC((432, 432, 432), inputs, comp, M, N=N, M=M,
                                                levels=levels, groups=tuple(groups),
                                                zero_head_init=True)
        for level, c in zip((3, 2, 1), (fc[2], fc[1], fc[0])):
            for ref in (1, 2):
                setattr(self, f"deconv_l{level}_{ref}",
                        DeformConv(c, c, groups=DEFORM_GROUPS, kernel=3))
        self.residual_temp_encoder = TemporalEnc(comp, N=N, M=M)
        self.residual_compressor = PixelCondELIC(comp, inputs, comp, M, N=N, M=M,
                                                 levels=levels, groups=tuple(groups))
        self.reconstructor = ReconstructorDeconv(channels=comp)

    def decoder_context(self, xref1, xref2):
        """What the decoder computes from the references: the conditioning
        pyramid, the offset prior's temporal condition, each reference's
        features."""
        fref1 = self.feature_extractor(xref1)
        fref2 = self.feature_extractor(xref2)
        cond = tuple(torch.cat([r1, r2], dim=-1) for r1, r2 in zip(fref1, fref2))
        return cond, self.offset_temp_encoder(*cond), fref1, fref2

    def fuse_offsets(self, heads, fref1, fref2):
        """The decoded offset heads -> each scale's two aligned maps side by
        side."""
        out = []
        for i in range(3):
            o1, o2 = torch.chunk(heads[i], 2, dim=-1)
            d1, d2 = (getattr(self, f"deconv_l{i + 1}_{r}") for r in (1, 2))
            out.append(torch.cat([d1(fref1[i], *head_to_deform(o1)),
                                  d2(fref2[i], *head_to_deform(o2))], dim=-1))
        return tuple(out)

    def residual_cond(self, x_comp):
        return self.residual_temp_encoder(*x_comp)

    def reconstruct(self, x1, x2, x3):
        return self.reconstructor(x1, x2, x3)

    def code(self, xref1, xref2, xcur, s, semantics: str):
        """-> (x_hat, bits (B,), latents {"off", "res", "off_z", "res_z"})."""
        cond, temp, fref1, fref2 = self.decoder_context(xref1, xref2)
        fcur = self.feature_extractor(xcur)
        inputs = tuple(torch.cat([c, f], dim=-1) for c, f in zip(cond, fcur))
        if semantics == "stream":
            heads, off_bits, off_y, off_z = self.offset_compressor.encode(inputs, cond, temp, s)
        else:
            heads, off_bits, off_y = self.offset_compressor.forward_eval(inputs, cond, temp, s)
            off_z = None
        x_comp = self.fuse_offsets(heads, fref1, fref2)
        res_inputs = tuple(torch.cat([f, xc], dim=-1) for f, xc in zip(fcur, x_comp))
        res_temp = self.residual_cond(x_comp)
        if semantics == "stream":
            residues, res_bits, res_y, res_z = self.residual_compressor.encode(
                res_inputs, x_comp, res_temp, s, x_pixel=xcur)
        else:
            residues, res_bits, res_y = self.residual_compressor.forward_eval(
                res_inputs, x_comp, res_temp, s, x_pixel=xcur)
            res_z = None
        x_hat = self.reconstruct(*(xc + r for xc, r in zip(x_comp, residues)))
        return x_hat, off_bits + res_bits, {"off": off_y, "res": res_y, "off_z": off_z,
                                            "res_z": res_z}

    def decode_work(self, xref1, xref2, s, latents):
        """The stream decoder's device work, for counting."""
        cond, temp, fref1, fref2 = self.decoder_context(xref1, xref2)
        heads = self.offset_compressor.decode_work(latents["off_z"], cond, temp, s)
        x_comp = self.fuse_offsets(heads, fref1, fref2)
        residues = self.residual_compressor.decode_work(latents["res_z"], x_comp,
                                                        self.residual_cond(x_comp), s)
        return self.reconstruct(*(xc + r for xc, r in zip(x_comp, residues)))


def build(cfg: dict) -> nn.Module:
    m = cfg["model"]
    return DeformB(feature_channels=tuple(m["feature_channels"]), N=m["N"], M=m["M"],
                   levels=m["levels"], groups=tuple(m["groups"]))


def _rate(cfg):
    return cfg["model"]["s"]


def b_frame(model, x_before, x_current, x_after, order, o1, o2, cfg, semantics: str):
    """DeformB codes a B-frame from its two references alone: the frames'
    places in the GOP do not enter."""
    return model.code(x_before, x_after, x_current, _rate(cfg), semantics)


def b_decode(model, x_before, x_after, latents, order, o1, o2, cfg):
    return model.decode_work(x_before, x_after, _rate(cfg), latents)


def assemble(model, calls: dict):
    """The reconstruction of a B-frame call from its last stage's inputs."""
    args, kw, _ = calls["reconstructor.forward"][0]
    return model.reconstructor(*args, **kw)


def follow(model, entry: dict, calls: dict, refs: dict, cfg: dict, semantics: str):
    """The steps between a B-frame call's stages (:mod:`reference.links`):
    the three feature pyramids of the references and the current frame, the
    conditions and the offset prior from them, the offset bottleneck, each
    deform convolution's inputs split from its head, the aligned maps, the
    residue prior and bottleneck (its pixel stage reading the source frame),
    the reconstructor. -> (links, symbol pairs, the reconstruction from the
    last stage)."""
    xb, xc, xa = entry["before"], entry["current"], entry["after"]
    links, flips = [], []
    B = xc.shape[0]
    s = _rate(cfg)
    rows = {}
    for j in range(B):
        rows.update({("b", j): (xb[j:j + 1],), ("a", j): (xa[j:j + 1],), ("c", j): (xc[j:j + 1],)})
    feats = L.match_rows(calls.get("feature_extractor.forward") or [], rows, 1)

    def pyramid(kind):
        return [torch.cat([feats[(kind, j)][i] for j in range(B)]) for i in range(3)]

    fref1, fref2, fcur = pyramid("b"), pyramid("a"), pyramid("c")
    cond = [torch.cat([r1, r2], dim=-1) for r1, r2 in zip(fref1, fref2)]
    t_args, _, temp = L.only(calls, "offset_temp_encoder.forward")
    links.append(("offset_temp_encoder", list(t_args), cond))
    d_args, _, d_out = L.only(calls, "decoder_context")
    links += [("decoder_context", list(d_args), [xb, xa]),
              ("decoder_context.out", d_out, [cond, temp, fref1, fref2])]
    inputs = [torch.cat([c, f], dim=-1) for c, f in zip(cond, fcur)]
    heads = _bottleneck("offset_compressor", model, calls, refs, inputs, cond, temp, s,
                        semantics, links, flips)
    f_args, _, x_comp = L.only(calls, "fuse_offsets")
    links.append(("fuse_offsets", list(f_args), [list(heads), fref1, fref2]))
    for i in range(3):
        halves = torch.chunk(heads[i], 2, dim=-1)
        aligned = []
        for r, (feat, head) in enumerate(zip((fref1[i], fref2[i]), halves), start=1):
            name = f"deconv_l{i + 1}_{r}"
            args, _, out = L.only(calls, f"{name}.forward")
            links.append((name, list(args), [feat, *head_to_deform(head)]))
            aligned.append(out)
        links.append((f"fuse_offsets.l{i + 1}", x_comp[i], torch.cat(aligned, dim=-1)))
    r_args, _, res_temp = L.only(calls, "residual_temp_encoder.forward")
    links.append(("residual_temp_encoder", list(r_args), list(x_comp)))
    c_args, _, c_out = L.only(calls, "residual_cond")
    links += [("residual_cond", list(c_args[0]), list(x_comp)),
              ("residual_cond.out", c_out, res_temp)]
    res_inputs = [torch.cat([f, c], dim=-1) for f, c in zip(fcur, x_comp)]
    residues = _bottleneck("residual_compressor", model, calls, refs, res_inputs, x_comp,
                           res_temp, s, semantics, links, flips)
    _, a_kw, _ = L.only(calls, "residual_compressor.analysis")
    links.append(("residual_compressor.analysis.x_pixel", a_kw.get("x_pixel"), xc))
    summed = [c + r for c, r in zip(x_comp, residues)]
    k_args, _, k_out = L.only(calls, "reconstruct")
    rc_args, _, x_hat = L.only(calls, "reconstructor.forward")
    links += [("reconstruct", list(k_args), summed), ("reconstructor", list(rc_args), summed),
              ("reconstruct.out", k_out, x_hat)]
    return links, flips, torch.clamp(x_hat, 0.0, 1.0)
