"""FlowGuidedB (ICIP 2024) B-frame codec: FlowNET estimates a flow pair
between the two references at /2 of the frame; both references' feature
pyramids are warped by the temporally scaled flow at each of three scales;
a conditional ELIC bottleneck codes per-scale deform offset heads around
the flow, which modulated deformable convolutions turn into the
compensated features; a second conditional bottleneck codes the feature
residues; a top-down reconstructor gives the frame.

Two semantics, as the program has them: the coder's stream path
(:meth:`CondELIC.encode`: z around the medians, checkerboard groups around
their means) and the eval's likelihood pass (:meth:`CondELIC.forward_eval`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import entropy as E
from . import links as L
from .cond_elic import OffsetELIC, ResELIC
from .deform import DeformConv
from .ms_feature import FlowNET, MSFeature, Reconstructor, TemporalEnc
from .pad import pad_to_multiple, unpad
from .resample import avg_pool2d, bilinear_resize
from .warp import warp

DEFORM_GROUPS = 8  # per reference; the fusion uses 2 * 8


def convert_scales(scale1, scale2):
    """Temporal scales rounded to 2 decimals, as float32 host scalars."""
    hundred = np.float32(100.0)
    return tuple(float(np.round(np.float32(s) * hundred) / hundred) for s in (scale1, scale2))


def get_scales(order, order1, order2):
    """flow_cur->ref1 = flow21 * (order - order1) / (order2 - order1), and
    symmetrically for ref2."""
    if order2 == order1:
        return 0.0, 0.0
    return (order - order1) / (order2 - order1), (order - order2) / (order1 - order2)


class OffsetDiversity(nn.Module):
    def __init__(self, features: int, magnitude: float):
        super().__init__()
        self.magnitude = magnitude
        self.DeformConv_0 = DeformConv(2 * features, features, groups=2 * DEFORM_GROUPS, kernel=3)

    def _prep(self, head, flow):
        """head (B,H,W,216) -> offsets (dy, dx per tap: tanh-bounded
        diversity around the flow) and sigmoid masks."""
        o1, o2, mask = torch.chunk(head, 3, dim=-1)
        offset = torch.tanh(torch.cat([o1, o2], dim=-1)) * self.magnitude
        offset = offset + flow.flip(-1).repeat(1, 1, 1, offset.shape[-1] // 2)
        return offset, torch.sigmoid(mask)

    def forward(self, x1, head1, flow1, x2, head2, flow2):
        off1, m1 = self._prep(head1, flow1)
        off2, m2 = self._prep(head2, flow2)
        return self.DeformConv_0(torch.cat([x1, x2], dim=-1), torch.cat([off1, off2], dim=-1),
                                 torch.cat([m1, m2], dim=-1))


class FlowGuidedB(nn.Module):
    def __init__(self, feature_channels=(64, 96, 128), N: int = 128, M: int = 128,
                 levels: int = 5, groups=(6, 6, 12, 24, 80)):
        super().__init__()
        fc = tuple(feature_channels)
        self.feature_extractor = MSFeature(channels=fc)
        self.flow_estimator = FlowNET()
        self.offset_temporal_conditioner = TemporalEnc(tuple(4 * c for c in fc), N=N, M=M)
        self.offset_compressor = OffsetELIC(tuple(5 * c for c in fc), tuple(4 * c for c in fc), M,
                                            N=N, M=M, levels=levels, groups=tuple(groups))
        self.offset_diversity_l3 = OffsetDiversity(fc[2], magnitude=10.0)
        self.offset_diversity_l2 = OffsetDiversity(fc[1], magnitude=20.0)
        self.offset_diversity_l1 = OffsetDiversity(fc[0], magnitude=40.0)
        self.residue_temporal_conditioner = TemporalEnc(fc, N=N, M=M)
        self.residual_compressor = ResELIC(tuple(2 * c for c in fc), fc, M, N=N, M=M,
                                           levels=levels, feature_channels=fc,
                                           groups=tuple(groups))
        self.reconstructor = Reconstructor(channels=fc)

    def estimate_flow(self, xref1, xref2, down_ratio: int):
        d1 = avg_pool2d(xref1, down_ratio * 2)
        d2 = avg_pool2d(xref2, down_ratio * 2)
        h, w = d1.shape[-3], d1.shape[-2]
        d1, _ = pad_to_multiple(d1, 16, mode="constant")
        d2, _ = pad_to_multiple(d2, 16, mode="constant")
        flow = unpad(self.flow_estimator(torch.cat([d1, d2], dim=-1)), (h, w))
        if down_ratio > 1:
            flow = bilinear_resize(flow, h * down_ratio, w * down_ratio) * down_ratio
        return flow

    def decoder_context(self, xref1, xref2, scale1, scale2, down_ratio: int):
        """What the decoder computes from the references: conditioning
        pyramids, temporal prior, per-scale scaled flows, reference features."""
        scale1, scale2 = convert_scales(scale1, scale2)
        flow = self.estimate_flow(xref1, xref2, down_ratio)
        fref1 = self.feature_extractor(xref1)
        fref2 = self.feature_extractor(xref2)
        cond, flows = [], []
        for i in range(3):
            f1, f2, w1, w2, flow = self.warped_refs_at_layer(fref1[i], fref2[i], flow,
                                                             scale1, scale2)
            cond.append(torch.cat([w1, w2, fref1[i], fref2[i]], dim=-1))
            flows.append((f1, f2))
        cond = tuple(cond)
        return cond, self.offset_temporal_conditioner(*cond), tuple(flows), fref1, fref2

    def warped_refs_at_layer(self, fref1, fref2, flow, scale1, scale2):
        """Scale and warp one pyramid level; the halved flow for the next."""
        flow_21, flow_12 = torch.chunk(flow, 2, dim=-1)
        flow_cur1, flow_cur2 = flow_21 * scale1, flow_12 * scale2
        down = bilinear_resize(flow, flow.shape[-3] // 2, flow.shape[-2] // 2) * 0.5
        return flow_cur1, flow_cur2, warp(fref1, flow_cur1), warp(fref2, flow_cur2), down

    def fuse_offsets(self, heads, fref1, fref2, flows):
        divs = (self.offset_diversity_l1, self.offset_diversity_l2, self.offset_diversity_l3)
        out = []
        for i in range(3):
            o1, o2 = torch.chunk(heads[i], 2, dim=-1)
            out.append(divs[i](fref1[i], o1, flows[i][0], fref2[i], o2, flows[i][1]))
        return tuple(out)

    def _front(self, xref1, xref2, xcur, scales, down_ratio):
        cond, temp, flows, fref1, fref2 = self.decoder_context(xref1, xref2, *scales, down_ratio)
        fcur = self.feature_extractor(xcur)
        inputs = tuple(torch.cat([c, f], dim=-1) for c, f in zip(cond, fcur))
        return cond, temp, flows, fref1, fref2, fcur, inputs

    def _finish(self, x_comp, residues):
        return self.reconstructor(*(xc + r for xc, r in zip(x_comp, residues)))

    def code(self, xref1, xref2, xcur, s, scales, semantics: str, down_ratio: int = 1):
        """-> (x_hat, bits (B,), latents {"off", "res", "off_z", "res_z"})."""
        cond, temp, flows, fref1, fref2, fcur, inputs = self._front(
            xref1, xref2, xcur, scales, down_ratio)
        if semantics == "stream":
            heads, off_bits, off_y, off_z = self.offset_compressor.encode(inputs, cond, temp, s)
        else:
            heads, off_bits, off_y = self.offset_compressor.forward_eval(inputs, cond, temp, s)
            off_z = None
        x_comp = self.fuse_offsets(heads, fref1, fref2, flows)
        res_inputs = tuple(torch.cat([f, xc], dim=-1) for f, xc in zip(fcur, x_comp))
        res_temp = self.residue_temporal_conditioner(*x_comp)
        if semantics == "stream":
            residues, res_bits, res_y, res_z = self.residual_compressor.encode(
                res_inputs, x_comp, res_temp, s)
        else:
            residues, res_bits, res_y = self.residual_compressor.forward_eval(
                res_inputs, x_comp, res_temp, s)
            res_z = None
        return self._finish(x_comp, residues), off_bits + res_bits, {
            "off": off_y, "res": res_y, "off_z": off_z, "res_z": res_z}

    def decode_work(self, xref1, xref2, s, scales, latents, down_ratio: int = 1):
        cond, temp, flows, fref1, fref2 = self.decoder_context(xref1, xref2, *scales, down_ratio)
        heads = self.offset_compressor.decode_work(latents["off_z"], cond, temp, s)
        x_comp = self.fuse_offsets(heads, fref1, fref2, flows)
        residues = self.residual_compressor.decode_work(
            latents["res_z"], x_comp, self.residue_temporal_conditioner(*x_comp), s)
        return self._finish(x_comp, residues)


def build(cfg: dict) -> nn.Module:
    m = cfg["model"]
    return FlowGuidedB(feature_channels=tuple(m["feature_channels"]), N=m["N"], M=m["M"],
                       levels=m["levels"], groups=tuple(m["groups"]))


def _rate(cfg, semantics):
    return cfg["model"]["s"] if semantics == "stream" else float(cfg["eval_level"])


def b_frame(model, x_before, x_current, x_after, order, o1, o2, cfg, semantics: str):
    return model.code(x_before, x_after, x_current, _rate(cfg, semantics),
                      get_scales(order, o1, o2), semantics)


def b_decode(model, x_before, x_after, latents, order, o1, o2, cfg):
    return model.decode_work(x_before, x_after, cfg["model"]["s"], get_scales(order, o1, o2),
                             latents)


def assemble(model, calls: dict):
    """The reconstruction of a B-frame call from its last stage's inputs."""
    args, kw, _ = calls["reconstructor.forward"][0]
    return model.reconstructor(*args, **kw)


def _bottleneck(name: str, model, calls: dict, refs: dict, inputs, conds, temporal, s,
                semantics: str, links: list, flips: list):
    """A CondELIC bottleneck named ``name``: analysis of ``inputs``, the
    hyper prior of z_hat with ``temporal``, the groups, the synthesis with
    ``conds``. -> the synthesis' outputs."""
    m = getattr(model, name)
    a_args, _, (y, z) = L.only(calls, f"{name}.analysis")
    links += [(f"{name}.analysis", list(a_args[:3]), list(inputs)),
              (f"{name}.analysis.s", torch.tensor(float(a_args[3])), torch.tensor(float(s)))]
    med = m.entropy_bottleneck.medians()
    z_hat = E.symbols(z, med) + med if semantics == "stream" else torch.round(z)
    h_args, _, hyper = L.only(calls, f"{name}.hyper_params")
    links += [(f"{name}.hyper_params", h_args[0], z_hat),
              (f"{name}.hyper_params.temporal", h_args[1], temporal)]
    y_ref = refs[f"{name}.analysis"][0][0]
    y_hat = L.checkerboard(f"{name}.group_params", m.groups, calls, refs, y, y_ref, hyper,
                           semantics, links, flips)
    s_args, _, out = L.only(calls, f"{name}.synthesis")
    links += [(f"{name}.synthesis", s_args[0], y_hat),
              (f"{name}.synthesis.conds", list(s_args[1:4]), list(conds))]
    return out


def follow(model, entry: dict, calls: dict, refs: dict, cfg: dict, semantics: str):
    """The steps between a B-frame call's stages (:mod:`reference.links`):
    the flow of the pooled references, the three feature pyramids, each
    level's scaled flows and warps (the scales worked out from the frames'
    places in the GOP), the conditions, the offset bottleneck, the deform
    fusion of its heads, the residue bottleneck, the reconstructor.
    -> (links, symbol pairs, the reconstruction from the last stage)."""
    xb, xc, xa = entry["before"], entry["current"], entry["after"]
    links, flips = [], []
    B = xc.shape[0]
    places = {get_scales(*o) for o in entry["order"]}
    if len(places) != 1:
        raise L.LinkError(f"one call codes frames of {len(places)} temporal geometries")
    scale1, scale2 = convert_scales(*places.pop())
    s = _rate(cfg, semantics)
    d1, _ = pad_to_multiple(avg_pool2d(xb, 2), 16, mode="constant")
    d2, _ = pad_to_multiple(avg_pool2d(xa, 2), 16, mode="constant")
    f_args, _, flow = L.only(calls, "flow_estimator.forward")
    links.append(("flow_estimator", f_args[0], torch.cat([d1, d2], dim=-1)))
    flow = unpad(flow, (xb.shape[1] // 2, xb.shape[2] // 2))
    rows = {}
    for j in range(B):
        rows.update({("b", j): (xb[j:j + 1],), ("a", j): (xa[j:j + 1],), ("c", j): (xc[j:j + 1],)})
    feats = L.match_rows(calls.get("feature_extractor.forward") or [], rows, 1)

    def pyramid(kind):
        return [torch.cat([feats[(kind, j)][i] for j in range(B)]) for i in range(3)]

    fref1, fref2, fcur = pyramid("b"), pyramid("a"), pyramid("c")
    warps = calls.get("warped_refs_at_layer") or []
    if len(warps) != 3:
        raise L.LinkError(f"warped_refs_at_layer: {len(warps)} calls, three expected")
    cond, flows = [], []
    for i, (args, _, (f1, f2, w1, w2, down)) in enumerate(warps):
        links += [("warped_refs_at_layer.refs", list(args[:2]), [fref1[i], fref2[i]]),
                  ("warped_refs_at_layer.flow", args[2], flow),
                  ("warped_refs_at_layer.scales", torch.tensor([float(args[3]), float(args[4])]),
                   torch.tensor([scale1, scale2]))]
        cond.append(torch.cat([w1, w2, fref1[i], fref2[i]], dim=-1))
        flows.append((f1, f2))
        flow = down
    t_args, _, temp = L.only(calls, "offset_temporal_conditioner.forward")
    links.append(("offset_temporal_conditioner", list(t_args), cond))
    inputs = [torch.cat([c, f], dim=-1) for c, f in zip(cond, fcur)]
    heads = _bottleneck("offset_compressor", model, calls, refs, inputs, cond, temp, s,
                        semantics, links, flips)
    x_comp = []
    for i in range(3):
        args, _, out = L.only(calls, f"offset_diversity_l{i + 1}.forward")
        o1, o2 = torch.chunk(heads[i], 2, dim=-1)
        links.append((f"offset_diversity_l{i + 1}", list(args),
                       [fref1[i], o1, flows[i][0], fref2[i], o2, flows[i][1]]))
        x_comp.append(out)
    r_args, _, res_temp = L.only(calls, "residue_temporal_conditioner.forward")
    links.append(("residue_temporal_conditioner", list(r_args), x_comp))
    res_inputs = [torch.cat([f, c], dim=-1) for f, c in zip(fcur, x_comp)]
    residues = _bottleneck("residual_compressor", model, calls, refs, res_inputs, x_comp,
                           res_temp, s, semantics, links, flips)
    rc_args, _, x_hat = L.only(calls, "reconstructor.forward")
    links.append(("reconstructor", list(rc_args), [c + r for c, r in zip(x_comp, residues)]))
    return links, flips, torch.clamp(x_hat, 0.0, 1.0)
