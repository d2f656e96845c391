"""LHBDC (TIP 2021) hierarchical bi-directional B-frame codec.

1. SPyNet flows between the two references (halved: the linear-motion
   priors of the current frame's flows) and from the current frame to each
   reference, pooled to /4 and reflect-padded to x64.
2. The flow differences are coded by a mean-scale hyperprior (4 channels).
3. Both references are warped by the decoded flows and blended by a
   sigmoid mask (MaskUNet); the pixel residual is coded by a second
   hyperprior.

The coder's quantisation and the eval's ('dequantize') are the same for
this codec: z around the medians, y around the means.
"""

from __future__ import annotations

import torch
from torch import nn

from . import links as L
from .hyperprior import MVCompressor, ResidualCompressor
from .pad import pad_to_multiple, unpad
from .resample import avg_pool2d, upsample_flow
from .spynet import SPyNet
from .unet import MaskUNet
from .warp import warp


class LHBDC(nn.Module):
    def __init__(self, N: int = 128):
        super().__init__()
        self.N = N
        self.flownet = SPyNet()
        self.mv_compressor = MVCompressor(N=N)
        self.residual_compressor = ResidualCompressor(N=N)
        self.masknet = MaskUNet()

    def _flow(self, first, second, halve: bool):
        f = self.flownet(first, second)
        f, _ = pad_to_multiple(avg_pool2d(f / 2.0 if halve else f, 4), 64)
        return f

    def motion_priors(self, x_before, x_after):
        return self._flow(x_before, x_after, True), self._flow(x_after, x_before, True)

    def motion_compensate(self, x_before, x_after, flow_cb_hat, flow_ca_hat, size):
        """Crop and x4-upsample the decoded flows, warp both references,
        blend by the mask."""
        fw = warp(x_before, upsample_flow(unpad(flow_cb_hat, size), 4), compat="lhbdc")
        bw = warp(x_after, upsample_flow(unpad(flow_ca_hat, size), 4), compat="lhbdc")
        mask = self.masknet(torch.cat([fw, bw], dim=-1))
        return mask * fw + (1.0 - mask) * bw

    def encode(self, x_before, x_current, x_after):
        """One B-frame (or a batch) -> (x_hat, bits (B,), latents): the
        quantized latents {"mv", "res"} and their hyper-latents."""
        flow_ba, flow_ab = self.motion_priors(x_before, x_after)
        mv_y, mv_z, mv_bits = self.mv_compressor.encode(self.flow_diff(x_before, x_current,
                                                                       x_after, flow_ba, flow_ab))
        x_pred = self.predict(x_before, x_after, flow_ba, flow_ab, mv_y)
        res_y, res_z, res_bits = self.residual_compressor.encode(x_current - x_pred)
        x_hat = x_pred + self.residual_compressor.synthesis(res_y)
        return x_hat, mv_bits + res_bits, {"mv": mv_y, "res": res_y, "mv_z": mv_z, "res_z": res_z}

    def flow_diff(self, x_before, x_current, x_after, flow_ba, flow_ab):
        flow_cb = self._flow(x_current, x_before, False)
        flow_ca = self._flow(x_current, x_after, False)
        return torch.cat([flow_cb - flow_ab, flow_ca - flow_ba], dim=-1)

    def predict(self, x_before, x_after, flow_ba, flow_ab, mv_y):
        d_cb, d_ca = torch.chunk(self.mv_compressor.synthesis(mv_y), 2, dim=-1)
        size = (x_before.shape[1] // 4, x_before.shape[2] // 4)
        return self.motion_compensate(x_before, x_after, d_cb + flow_ab, d_ca + flow_ba, size)

    def decode_work(self, x_before, x_after, latents):
        """The decoder's device work from the references and the stream:
        flow priors, both codecs' entropy parameters and syntheses, the
        compensation."""
        flow_ba, flow_ab = self.motion_priors(x_before, x_after)
        self.mv_compressor.entropy_params(latents["mv_z"])
        x_pred = self.predict(x_before, x_after, flow_ba, flow_ab, latents["mv"])
        return x_pred + self.residual_compressor.decode_work(latents["res_z"], latents["res"])


def build(cfg: dict) -> nn.Module:
    return LHBDC(N=cfg["model"]["N"])


def b_frame(model, x_before, x_current, x_after, order, o1, o2, cfg, semantics: str):
    """(x_hat, bits (B,), latents) of one B-frame under ``semantics``
    ("stream" or "eval"); for LHBDC the two are the same."""
    return model.encode(x_before, x_current, x_after)


def b_decode(model, x_before, x_after, latents, order, o1, o2, cfg):
    return model.decode_work(x_before, x_after, latents)


def assemble(model, calls: dict):
    """The reconstruction of a B-frame call from its stages' inputs: the
    compensation and the residual's synthesis."""
    args, kw, _ = calls["motion_compensate"][0]
    res_args, res_kw, _ = calls["residual_compressor.synthesis"][0]
    return model.motion_compensate(*args, **kw) + model.residual_compressor.synthesis(
        *res_args, **res_kw)


def follow(model, entry: dict, calls: dict, refs: dict, cfg: dict, semantics: str):
    """The steps between a B-frame call's stages (:mod:`reference.links`),
    the same in both semantics: SPyNet on the four pairs of each frame
    (references both ways, current to each reference), the flow
    differences from the priors, the MV codec, its flows plus the priors
    into the compensation, the residual, the residual codec. -> (links,
    symbol pairs, the reconstruction from the last stages' outputs)."""
    xb, xc, xa = entry["before"], entry["current"], entry["after"]
    links, flips = [], []
    B = xc.shape[0]
    pairs = {}
    for j in range(B):
        b, c, a = xb[j:j + 1], xc[j:j + 1], xa[j:j + 1]
        pairs.update({("ba", j): (b, a), ("ab", j): (a, b), ("cb", j): (c, b), ("ca", j): (c, a)})
    flows = L.match_rows(calls.get("flownet.forward") or [], pairs, 2)

    def pooled(kind, halve):
        f = torch.cat([flows[(kind, j)][0] for j in range(B)])
        return pad_to_multiple(avg_pool2d(f / 2.0 if halve else f, 4), 64)[0]

    flow_ba, flow_ab = pooled("ba", True), pooled("ab", True)
    diff = torch.cat([pooled("cb", False) - flow_ab, pooled("ca", False) - flow_ba], dim=-1)
    mv = model.mv_compressor.entropy_bottleneck.medians()
    d_cb, d_ca = torch.chunk(L.hyperprior("mv_compressor", calls, refs, mv, diff, links, flips),
                             2, dim=-1)
    mc_args, _, x_pred = L.only(calls, "motion_compensate")
    size = (xb.shape[1] // 4, xb.shape[2] // 4)
    links += [("motion_compensate.before", mc_args[0], xb),
              ("motion_compensate.after", mc_args[1], xa),
              ("motion_compensate.flow_cb", mc_args[2], d_cb + flow_ab),
              ("motion_compensate.flow_ca", mc_args[3], d_ca + flow_ba),
              ("motion_compensate.size", torch.tensor(tuple(mc_args[4])), torch.tensor(size))]
    med = model.residual_compressor.entropy_bottleneck.medians()
    res = L.hyperprior("residual_compressor", calls, refs, med, xc - x_pred, links, flips)
    return links, flips, torch.clamp(x_pred + res, 0.0, 1.0)
