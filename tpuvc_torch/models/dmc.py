"""DMC, the low-delay P-frame conditional codec with content-adaptive
inference of OJSP 2025 (port of tpuvc.models.dmc).

- Motion: SPyNet flow (``warp_compat="exact"``) at a fractional down ratio
  (antialiased resize, edge pad to x64, the flow rescaled by the realised
  ratio), coded divided by the ratio and multiplied back after decoding.
- A DCVC-style decoded picture buffer dict {ref_frame, ref_feature,
  ref_mv_feature, ref_y, ref_mv_y, ref_down_ratio} carried from frame to
  frame; missing entries mean "first P-frame after an I-frame".
- Conditional coding: the frame is coded against a motion-compensated
  48-channel feature context (the feature and the reference frame warped by
  the decoded MV), not as an explicit residual.
- Each latent is coded by a :class:`_FourPartCoder`: a hyperprior fused with
  the previous frame's decoded latent (the temporal prior), four sequential
  parts (2x2 spatial phases crossed with the two channel halves), each later
  part's parameters refined by an adaptor conv over the parts already
  decoded, a content-adaptive quantization step, Laplace likelihoods, and
  per-level gain vectors interpolated geometrically over a fractional q.

tpuvc orders its two warps with ``sequenced`` against a TPU scheduling
hazard; kernels on one CUDA stream run in issue order, so the port has no
counterpart.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuvc_torch import resolve_device
from tpuvc_torch.coder.parallel import CtxPool
from tpuvc_torch.entropy.bottleneck import FactorizedBottleneck, FactorizedTables
from tpuvc_torch.entropy.emath import clip, likelihood_to_bits
from tpuvc_torch.entropy.laplace import LaplaceConditional
from tpuvc_torch.entropy.quant import quantize
from tpuvc_torch.models.layers import (
    Conv,
    ResidualBottleneckBlock,
    SubpelConv,
    init_weights,
    leaky_relu,
)
from tpuvc_torch.models.spynet import SPyNet
from tpuvc_torch.ops.pad import pad_to_multiple, unpad
from tpuvc_torch.ops.precision import set_deterministic
from tpuvc_torch.ops.resample import bilinear_resize, resize_antialias
from tpuvc_torch.ops.warp import warp


# --- four-part partition: 2x2 spatial phases x channel halves ------------
#
# Part k codes spatial phase k of the first channel half and phase 3-k of
# the second half: every part sees both channel halves and both row
# parities, so each adaptor step conditions on spatially and channel-wise
# adjacent decoded values.

_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


def part_mask(h: int, w: int, c: int, k: int, device=None, y0: int = 0) -> torch.Tensor:
    """(h, w, c) float mask of part k's coded positions; ``y0``: the row of
    the frame the mask's first row is (its row parity)."""
    r = (torch.arange(h, device=device)[:, None, None] + y0) % 2
    s = torch.arange(w, device=device)[None, :, None] % 2
    first = torch.arange(c, device=device)[None, None, :] < c // 2
    (r0, s0), (r1, s1) = _PHASES[k], _PHASES[3 - k]
    m = torch.where(first, (r == r0) & (s == s0), (r == r1) & (s == s1))
    return m.to(torch.float32)


def part_squeeze(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, C) compact view of part k."""
    c0 = x.shape[-1] // 2
    (r0, s0), (r1, s1) = _PHASES[k], _PHASES[3 - k]
    return torch.cat([x[:, r0::2, s0::2, :c0], x[:, r1::2, s1::2, c0:]], dim=-1)


def part_scatter(full: torch.Tensor, vals: torch.Tensor, k: int) -> torch.Tensor:
    """A new tensor: ``full`` with part k's compact values written back."""
    c0 = full.shape[-1] // 2
    (r0, s0), (r1, s1) = _PHASES[k], _PHASES[3 - k]
    out = full.clone()
    out[:, r0::2, s0::2, :c0] = vals[..., :c0]
    out[:, r1::2, s1::2, c0:] = vals[..., c0:]
    return out


def _q_step(raw: torch.Tensor) -> torch.Tensor:
    """Positive content-adaptive quantization step, ~1 at init."""
    return torch.exp(clip(raw, -3.0, 3.0))


def split_params(p: torch.Tensor) -> tuple:
    """A part's 3N entropy parameters -> (q_step, scales, means)."""
    qs_raw, scales, means = torch.chunk(p, 3, dim=-1)
    return _q_step(qs_raw), scales, means


class _FourPartCoder(nn.Module):
    """Latent coder: hyper + temporal prior -> fused (q_step, scales, means)
    -> four-part sequential coding with Laplace likelihoods, plus per-level
    gain vectors (geometric interpolation over a fractional level q)."""

    def __init__(self, N: int, levels: int = 4):
        super().__init__()
        self.N, self.levels = N, levels
        self.h_a1 = Conv(N, N, kernel=3)
        self.h_a2 = Conv(N, N, kernel=5, stride=2)
        self.h_a3 = Conv(N, N, kernel=5, stride=2)
        self.h_s1 = SubpelConv(N, N, r=2)
        self.h_s2 = SubpelConv(N, N * 3 // 2, r=2)
        self.h_s3 = Conv(N * 3 // 2, N * 2, kernel=3)
        self.entropy_bottleneck = FactorizedBottleneck(channels=N)
        self.laplace = LaplaceConditional()
        # temporal latent prior over the previous frame's decoded latent
        self.t_prior1 = Conv(N, N, kernel=3)
        self.t_prior2 = Conv(N, N, kernel=3)
        self.fusion1 = Conv(3 * N, 3 * N, kernel=1)
        self.fusion2 = Conv(3 * N, 3 * N, kernel=1)
        self.adaptors = nn.ModuleList(Conv(4 * N, 3 * N, kernel=3) for _ in range(3))
        self.gain = nn.Parameter(torch.ones(levels, N))
        self.inv_gain = nn.Parameter(torch.ones(levels, N))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.gain.fill_(1.0)
        self.inv_gain.fill_(1.0)

    def _interp(self, g: torch.Tensor, q) -> torch.Tensor:
        """|g[hi]|^(1-l) * |g[lo]|^l with hi = ceil(q), lo = floor(q),
        l = hi - q; the exponents in float32, as tpuvc computes them."""
        q32 = np.clip(np.float32(q), np.float32(0.0), np.float32(self.levels - 1))
        hi = int(np.clip(np.ceil(q32), 0, self.levels - 1))
        lo = int(np.clip(np.floor(q32), 0, self.levels - 1))
        l32 = np.float32(hi) - q32
        e_hi, e_lo = float(np.float32(1.0) - l32), float(l32)
        return torch.abs(g[hi]) ** e_hi * torch.abs(g[lo]) ** e_lo

    # --- shared stages -------------------------------------------------

    def hyper_analysis(self, y, q=0.0):
        """(gained y, z): the encoder-side analysis."""
        y = y * self._interp(self.gain, q)
        z = self.h_a3(F.relu(self.h_a2(F.relu(self.h_a1(y)))))
        return y, z

    def fused_params(self, z_hat, ctx):
        """Hyper decoder + temporal latent prior -> fused 3N params.

        ctx: the previous frame's decoded latent (B, h, w, N), or None (the
        first P-frame after an I-frame: a zero temporal prior)."""
        p = self.h_s3(F.relu(self.h_s2(F.relu(self.h_s1(z_hat)))))
        if ctx is None:
            ctx = torch.zeros(p.shape[:3] + (self.N,), dtype=p.dtype, device=p.device)
        t = self.t_prior2(F.relu(self.t_prior1(ctx)))
        return self.fusion2(F.relu(self.fusion1(torch.cat([p, t], dim=-1))))

    def part_params(self, params0, y_hat, k: int):
        """Entropy parameters for part k: the fused params for part 0, an
        adaptor conv over (fused params, decoded so far) for parts 1-3.
        Returns full-resolution (q_step, scales, means)."""
        p = params0 if k == 0 else self.adaptors[k - 1](torch.cat([params0, y_hat], dim=-1))
        return split_params(p)

    def code_part(self, y, y_hat, y_lik, params, k: int, mode: str, generator=None,
                  y0: int = 0):
        """Part k's Laplace step: (y_hat, y_lik) with part k's positions
        coded from its (q_step, scales, means); ``y0``: the frame's row of
        y's first row (the parts' row parity)."""
        q_step, scales, means = params
        v_hat, lik = self.laplace((y - means) * q_step, scales, mode=mode, generator=generator)
        m = part_mask(*y.shape[1:], k, device=y.device, y0=y0)
        return (y_hat + m * (v_hat / q_step + means),
                y_lik * torch.where(m > 0, lik, torch.ones_like(lik)))

    def apply_inv_gain(self, y_hat, q=0.0):
        return y_hat * self._interp(self.inv_gain, q)

    # --- training / eval forward ---------------------------------------

    def forward(self, y, ctx, mode: str, generator=None, q=0.0):
        y, z = self.hyper_analysis(y, q=q)
        z_hat, z_lik = self.entropy_bottleneck(z, mode, generator=generator)
        params0 = self.fused_params(z_hat, ctx)
        y_hat = torch.zeros_like(y)
        y_lik = torch.ones_like(y)
        for k in range(4):
            y_hat, y_lik = self.code_part(y, y_hat, y_lik, self.part_params(params0, y_hat, k),
                                          k, mode, generator)
        return self.apply_inv_gain(y_hat, q), {"y": y_lik, "z": z_lik}

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()


MV_FEAT = 8  # propagated motion feature channels (DCVC ref_mv_feature)


def down_size(H: int, W: int, ratio: float) -> tuple[int, int]:
    """The (h, w) a frame's flow is estimated at for a down ratio: H/ratio
    and W/ratio rounded down to multiples of 8, at least 64."""
    return (max(int(round(H / ratio)) // 8 * 8, 64), max(int(round(W / ratio)) // 8 * 8, 64))


class PFrameDMC(nn.Module):
    """The P-frame codec at feature width ``feat`` and latent width ``N``.
    ``generator`` draws the initial weights; a trained model loads a state
    dict instead (tpuvc_torch.utils.convert)."""

    def __init__(self, feat: int = 48, N: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.feat, self.N = feat, N
        self.optic_flow = SPyNet(warp_compat="exact")
        # MV codec: analysis/synthesis over [flow, ref_mv_feature] at /8.
        self.mv_g_a = nn.ModuleList([
            Conv(2 + MV_FEAT, N, kernel=5, stride=2),
            Conv(N, N, kernel=5, stride=2),
            Conv(N, N, kernel=5, stride=2),
        ])
        self.mv_g_s = nn.ModuleList([
            SubpelConv(N, N, r=2), SubpelConv(N, N, r=2), SubpelConv(N, MV_FEAT, r=2),
        ])
        self.mv_out = Conv(MV_FEAT, 2, kernel=3)
        self.mv_coder = _FourPartCoder(N)
        # Feature extractor over the reference frame, fused with the
        # propagated ref_feature.
        self.feat_in = Conv(3 + feat, feat, kernel=3)
        self.feat_blocks = nn.ModuleList(ResidualBottleneckBlock(feat) for _ in range(2))
        # Context refinement after warping.
        self.ctx_refine = nn.ModuleList([
            Conv(feat + 3 + 2, feat, kernel=3),
            ResidualBottleneckBlock(feat),
            ResidualBottleneckBlock(feat),
        ])
        # Conditional contextual codec at /8 with context injection.
        self.g_a_layers = nn.ModuleList([
            Conv(3 + feat, N, kernel=5, stride=2),
            ResidualBottleneckBlock(N),
            Conv(N, N, kernel=5, stride=2),
            ResidualBottleneckBlock(N),
            Conv(N, N, kernel=5, stride=2),
        ])
        self.y_coder = _FourPartCoder(N)
        self.g_s_layers = nn.ModuleList([
            SubpelConv(N, N, r=2),
            ResidualBottleneckBlock(N),
            SubpelConv(N, N, r=2),
            ResidualBottleneckBlock(N),
            SubpelConv(N, feat, r=2),
        ])
        self.recon_head = nn.ModuleList([
            Conv(2 * feat, feat, kernel=3),
            ResidualBottleneckBlock(feat),
            ResidualBottleneckBlock(feat),
        ])
        self.to_rgb = Conv(feat, 3, kernel=3)
        if generator is not None:
            init_weights(self, generator)

    # --- motion ---

    def estimate_mv(self, x, ref_frame, ratio: float):
        """Flow at a fractional down ratio (x and ref at 1/ratio), resized
        back to full resolution."""
        H, W = x.shape[-3], x.shape[-2]
        if ratio == 1.0:
            return self.optic_flow(x, ref_frame)
        h, w = down_size(H, W, ratio)
        # Replicate-pad to x64 so the SPyNet pyramid stays even at every
        # level, then crop the flow back.
        xd, _ = pad_to_multiple(resize_antialias(x, h, w), 64, mode="edge")
        rd, _ = pad_to_multiple(resize_antialias(ref_frame, h, w), 64, mode="edge")
        mv = unpad(self.optic_flow(xd, rd), (h, w))
        # Magnitude scale W/w is the ratio the resize realised.
        return bilinear_resize(mv, H, W) * (W / w)

    def _mv_feat(self, x, ref_mv_feature):
        """MV codec input: [scaled flow, propagated mv feature]."""
        if ref_mv_feature is None:
            B, H, W, _ = x.shape
            ref_mv_feature = torch.zeros((B, H, W, MV_FEAT), dtype=x.dtype, device=x.device)
        return torch.cat([x, ref_mv_feature], dim=-1)

    def _mv_analysis_y(self, mv_scaled, ref_mv_feature):
        y = self._mv_feat(mv_scaled, ref_mv_feature)
        n = len(self.mv_g_a)
        for i, layer in enumerate(self.mv_g_a):
            y = layer(y) if i == n - 1 else leaky_relu(layer(y))
        return y

    def _mv_decode(self, x):
        """mv synthesis after the inverse gain -> (mv, mv_feature)."""
        for layer in self.mv_g_s:
            x = leaky_relu(layer(x))
        return self.mv_out(x), x

    def code_mv(self, mv_scaled, ref_mv_feature, ref_mv_y, mode, generator=None, q=0.0):
        y = self._mv_analysis_y(mv_scaled, ref_mv_feature)
        y_hat, lik = self.mv_coder(y, ref_mv_y, mode, generator, q=q)
        mv, feature = self._mv_decode(y_hat)
        return mv, feature, y_hat, lik

    def ref_features(self, ref_frame, ref_feature):
        if ref_feature is None:
            # First P-frame after an I-frame: no propagated feature yet.
            B, H, W, _ = ref_frame.shape
            ref_feature = torch.zeros((B, H, W, self.feat), dtype=ref_frame.dtype,
                                      device=ref_frame.device)
        f = self.feat_in(torch.cat([ref_frame, ref_feature], dim=-1))
        for b in self.feat_blocks:
            f = b(f)
        return f

    def motion_compensate(self, ref_frame, ref_feature, mv_hat):
        f = self.ref_features(ref_frame, ref_feature)
        warped_f = warp(f, mv_hat)
        warped_x = warp(ref_frame, mv_hat)
        x = self.ctx_refine[0](torch.cat([warped_f, warped_x, mv_hat], dim=-1))
        for b in self.ctx_refine[1:]:
            x = b(x)
        return x, warped_x

    # --- conditional coding ---

    def _frame_analysis_y(self, x, context):
        y = torch.cat([x, context], dim=-1)
        for layer in self.g_a_layers:
            y = layer(y)
        return y

    def _frame_decode(self, f, context):
        """Frame synthesis after the inverse gain -> (x_hat, feature)."""
        for layer in self.g_s_layers:
            f = layer(f)
        f = self.recon_head[0](torch.cat([f, context], dim=-1))
        for b in self.recon_head[1:]:
            f = b(f)
        return self.to_rgb(f), f

    def code_frame(self, x, context, ref_y, mode, generator=None, q=0.0):
        y = self._frame_analysis_y(x, context)
        y_hat, lik = self.y_coder(y, ref_y, mode, generator, q=q)
        x_hat, f = self._frame_decode(y_hat, context)
        return x_hat, f, y_hat, lik

    def forward(self, x, dpb: dict, ratio: float = 1.0, mode: str = "ste",
                generator: torch.Generator | None = None, q=0.0):
        """Code one P-frame against the DPB (likelihood forward).

        dpb: {"ref_frame": (B,H,W,3), "ref_feature": (B,H,W,feat) | None,
        "ref_mv_feature": (B,H,W,MV_FEAT) | None, "ref_y": latent | None,
        "ref_mv_y": latent | None, "ref_down_ratio": float}; missing or None
        entries mean "first P-frame after intra". q: the rate level
        (fractional allowed). ``mode="noise"`` draws from ``generator``.
        Returns a dict with x_hat, warped, bits (bits_mv, bits_y), rate and
        the updated dpb.
        """
        B, H, W, _ = x.shape
        ref_frame = dpb["ref_frame"]
        est_mv = self.estimate_mv(x, ref_frame, ratio)
        # OJSP MV scaling: code est_mv / ratio, decode mv_hat * ratio.
        mv_hat, mv_feature, mv_y_hat, mv_lik = self.code_mv(
            est_mv / ratio, dpb.get("ref_mv_feature"), dpb.get("ref_mv_y"),
            mode, generator, q=q,
        )
        mv_hat = mv_hat * ratio
        context, warped_x = self.motion_compensate(ref_frame, dpb.get("ref_feature"), mv_hat)
        x_hat, feature, y_hat, y_lik = self.code_frame(
            x, context, dpb.get("ref_y"), mode, generator, q=q
        )
        bits_mv = sum(likelihood_to_bits(p) for p in mv_lik.values())
        bits_y = sum(likelihood_to_bits(p) for p in y_lik.values())
        bits = bits_mv + bits_y
        return {
            "x_hat": x_hat,
            "warped": warped_x,
            "bits": bits,
            "bits_mv": bits_mv,
            "bits_y": bits_y,
            "rate": bits / (B * H * W),
            "dpb": {
                "ref_frame": clip(x_hat, 0.0, 1.0),
                "ref_feature": feature,
                "ref_mv_feature": mv_feature,
                "ref_y": y_hat,
                "ref_mv_y": mv_y_hat,
                "ref_down_ratio": ratio,
            },
        }

    def warp_prediction(self, x, ref_frame, ratio: float):
        """Warp-only prediction for the fractional-ratio search."""
        return warp(ref_frame, self.estimate_mv(x, ref_frame, ratio))

    def aux_loss(self):
        return self.mv_coder.aux_loss() + self.y_coder.aux_loss()

    # --- staged methods for the real-bitstream coder ---

    def mv_analysis(self, x, ref_frame, ref_mv_feature, ratio: float, q=0.0):
        """est_mv -> gained mv latent + hyper latent (encoder side)."""
        est_mv = self.estimate_mv(x, ref_frame, ratio)
        return self.mv_coder.hyper_analysis(
            self._mv_analysis_y(est_mv / ratio, ref_mv_feature), q=q
        )

    def mv_fused_params(self, z_hat, ref_mv_y):
        return self.mv_coder.fused_params(z_hat, ref_mv_y)

    def mv_part_params(self, params0, y_hat, k: int):
        return self.mv_coder.part_params(params0, y_hat, k)

    def mv_synthesis(self, y_hat, ratio: float, q=0.0):
        """-> (mv_hat * ratio, mv_feature)."""
        mv, feature = self._mv_decode(self.mv_coder.apply_inv_gain(y_hat, q=q))
        return mv * ratio, feature

    def frame_analysis(self, x, context, q=0.0):
        return self.y_coder.hyper_analysis(self._frame_analysis_y(x, context), q=q)

    def frame_fused_params(self, z_hat, ref_y):
        return self.y_coder.fused_params(z_hat, ref_y)

    def frame_part_params(self, params0, y_hat, k: int):
        return self.y_coder.part_params(params0, y_hat, k)

    def frame_synthesis(self, y_hat, context, q=0.0):
        return self._frame_decode(self.y_coder.apply_inv_gain(y_hat, q=q), context)


class PFrameDMCCoder:
    """Real-bitstream encode/decode for the DMC P-frame codec.

    Transforms and entropy parameters on the device, rANS symbol coding on
    the host. The decoder rebuilds the motion-compensated context from the
    DPB and the coded MV alone; the down ratio and q ride the
    PFrameBitstream header.

    Each latent's four parts code in sequence: part k's entropy parameters
    depend on parts < k, so the host coder and the device alternate four
    times a latent. Encoder and decoder derive each part's (q_step, means,
    bucket indexes) through one function (:meth:`_part`) on tensors of the
    same shape and layout, with deterministic CUDA kernels
    (:func:`set_deterministic`; the warp kernel uses no atomics), so they
    agree bit for bit. Symbols ride squeezed (h/2, w/2, N) int16 tensors,
    bucket indexes uint8.

    ``device`` defaults to ``cuda``; the model moves there. Inputs are NHWC
    float32 frames whose sides divide by 64. :meth:`close` stops the host
    coding thread.
    """

    def __init__(self, model: PFrameDMC, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_deterministic(self.device)
        self.model = model.to(self.device).eval()
        self.laplace = LaplaceConditional()
        self.y_tables = self.laplace.build_tables()
        self.tables = {
            name: FactorizedTables.from_module(getattr(model, name).entropy_bottleneck)
            for name in ("mv_coder", "y_coder")
        }
        self.medians = {name: torch.from_numpy(t.medians).to(self.device)
                        for name, t in self.tables.items()}
        # One worker: streams finish in submission order anyway; the point
        # is overlapping host rANS with the next frame's device work.
        self._pool = CtxPool(max_workers=1)

    def close(self) -> None:
        """Wait for the pending host coding and stop its thread."""
        self._pool.shutdown(wait=True)

    def _on_stream(self):
        """A context that puts a worker thread's device work on the current
        stream of the calling thread (all three decode chains and the host
        fetches share one stream, which orders them)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext
        stream = torch.cuda.current_stream(self.device)
        return lambda: torch.cuda.stream(stream)

    # --- per-latent four-part coding -----------------------------------

    def _part(self, coder: _FourPartCoder, params0, y_hat, k: int):
        """Squeezed (q_step, means, uint8 rANS bucket indexes) of part k:
        one definition for encoder and decoder."""
        q_step, scales, means = coder.part_params(params0, y_hat, k)
        return (
            part_squeeze(q_step, k),
            part_squeeze(means, k),
            part_squeeze(self.laplace.build_indexes(scales), k).to(torch.uint8),
        )

    def _enc_four_part(self, coder, y, params0):
        """Encoder: sequential part coding with on-device squeezed symbols.
        -> (y_hat, [(sym, idx)] * 4)."""
        y_hat = torch.zeros_like(y)
        out = []
        for k in range(4):
            q_step, means, idx = self._part(coder, params0, y_hat, k)
            sym = quantize((part_squeeze(y, k) - means) * q_step, "symbols16")
            y_hat = part_scatter(y_hat, sym.float() / q_step + means, k)
            out.append((sym, idx))
        return y_hat, out

    def _dec_four_part(self, coder, shape, params0, streams):
        """Decoder: four sequential host rANS reads, each conditioned on the
        parts already reconstructed."""
        from tpuvc_torch.coder import decode_with_indexes

        t = self.y_tables
        y_hat = torch.zeros(shape, dtype=torch.float32, device=self.device)
        for k in range(4):
            q_step, means, idx_dev = self._part(coder, params0, y_hat, k)
            idx = idx_dev.cpu().numpy()
            sym = decode_with_indexes(
                streams[k], idx, t.cdfs, t.cdf_lengths, t.offsets
            ).reshape(idx.shape).astype(np.int16)
            vals = torch.from_numpy(sym).to(self.device).float() / q_step + means
            y_hat = part_scatter(y_hat, vals, k)
        return y_hat

    def _quantize_z(self, name, z):
        """(z symbols int16, z_hat) around the factorized prior's medians."""
        sym = quantize(z, "symbols16", means=self.medians[name])
        return sym, sym.float() + self.medians[name]

    def _decode_z(self, name, string, z_shape, batch=1):
        from tpuvc_torch.coder import decode_with_indexes

        t = self.tables[name]
        zh, zw = z_shape
        zc = self.model.N
        z_idx = np.broadcast_to(np.arange(zc, dtype=np.int32), (batch, zh, zw, zc))
        z_sym = decode_with_indexes(
            string, z_idx, t.cdfs, t.cdf_lengths, t.offsets
        ).reshape(batch, zh, zw, zc).astype(np.int16)
        return torch.from_numpy(z_sym).to(self.device).float() + self.medians[name]

    def _enc_transforms(self, x, dpb, ratio, q):
        """Encode-side device chain with on-device symbol quantization,
        composed of the functions the decoder runs (the fused params,
        :meth:`_part`, the MV synthesis, the compensation, the frame
        synthesis); the glue between them (rounding, mean addition, part
        scatter) is exact elementwise arithmetic. No host fetch, so the new
        DPB is usable at once and host rANS runs after the fact."""
        m = self.model
        ref = dpb["ref_frame"]
        mv_y, mv_z = m.mv_analysis(x, ref, dpb.get("ref_mv_feature"), ratio, q)
        mv_z_sym, mv_z_hat = self._quantize_z("mv_coder", mv_z)
        mv_params0 = m.mv_fused_params(mv_z_hat, dpb.get("ref_mv_y"))
        mv_y_hat, mv_parts = self._enc_four_part(m.mv_coder, mv_y, mv_params0)
        mv_hat, mv_feature = m.mv_synthesis(mv_y_hat, ratio, q)
        context, _ = m.motion_compensate(ref, dpb.get("ref_feature"), mv_hat)
        y, z = m.frame_analysis(x, context, q)
        z_sym, z_hat = self._quantize_z("y_coder", z)
        params0 = m.frame_fused_params(z_hat, dpb.get("ref_y"))
        y_hat, y_parts = self._enc_four_part(m.y_coder, y, params0)
        x_hat, feature = m.frame_synthesis(y_hat, context, q)
        return {
            "mv_z_sym": mv_z_sym,
            "mv_parts": mv_parts,
            "z_sym": z_sym,
            "y_parts": y_parts,
            "x_hat": clip(x_hat, 0.0, 1.0),
            "feature": feature,
            "mv_feature": mv_feature,
            "mv_y_hat": mv_y_hat,
            "y_hat": y_hat,
        }

    def _pack_streams(self, out, ratio, q, z_shape):
        """Host side of encode: fetch symbols and indexes, rANS to bytes.
        Stream order: mv parts 0-3, mv z, y parts 0-3, z."""
        from tpuvc_torch.coder import encode_with_indexes
        from tpuvc_torch.coder.container import PFrameBitstream

        t = self.y_tables

        def pack_parts(parts):
            return [
                encode_with_indexes(sym.cpu().numpy(), idx.cpu().numpy(),
                                    t.cdfs, t.cdf_lengths, t.offsets)
                for sym, idx in parts
            ]

        def pack_z(name, key):
            sym = out[key].cpu().numpy()
            idx = np.broadcast_to(np.arange(sym.shape[-1], dtype=np.int32), sym.shape)
            tz = self.tables[name]
            return encode_with_indexes(sym, idx, tz.cdfs, tz.cdf_lengths, tz.offsets)

        streams = (
            pack_parts(out["mv_parts"]) + [pack_z("mv_coder", "mv_z_sym")]
            + pack_parts(out["y_parts"]) + [pack_z("y_coder", "z_sym")]
        )
        return PFrameBitstream(
            q_milli=int(round(q * 1000)), ratio_centi=int(round(ratio * 100)),
            z_shape=z_shape, streams=streams,
        )

    @torch.no_grad()
    def encode_async(self, x, dpb: dict, ratio: float = 1.0, q: float = 0.0):
        """Issue the device chain and return (Future[PFrameBitstream],
        new_dpb) at once: the DPB feeds the next frame without waiting for
        the host rANS, which runs on the worker thread."""
        out = self._enc_transforms(x.to(self.device), dpb, ratio, q)
        new_dpb = {
            "ref_frame": out["x_hat"],
            "ref_feature": out["feature"],
            "ref_mv_feature": out["mv_feature"],
            "ref_y": out["y_hat"],
            "ref_mv_y": out["mv_y_hat"],
            "ref_down_ratio": ratio,
        }
        z_shape = tuple(int(v) for v in out["mv_z_sym"].shape[1:3])
        on_stream = self._on_stream()

        def host():
            with on_stream():
                return self._pack_streams(out, ratio, q, z_shape)

        return self._pool.submit(host), new_dpb

    def encode(self, x, dpb: dict, ratio: float = 1.0, q: float = 0.0):
        """Code one P-frame; returns (PFrameBitstream, new_dpb)."""
        fut, new_dpb = self.encode_async(x, dpb, ratio, q)
        return fut.result(), new_dpb

    def decode(self, dpb: dict, bits):
        """Decode one P-frame; returns (x_hat, new_dpb): the single-frame
        view of :meth:`decode_sequence` (one definition, no drift)."""
        xs, new_dpb = self.decode_sequence(dpb, [bits])
        return xs[0], new_dpb

    @torch.no_grad()
    def decode_sequence(self, dpb: dict, bits_list):
        """Pipelined low-delay decode of a chain of P-frames.

        Frame k's MV-latent decode needs only frame k-1's ``mv_y_hat`` (the
        temporal prior) and its frame-latent decode only k-1's ``y_hat``;
        only the join (compensation + synthesis, no host round trips) needs
        the reconstruction of k-1. So the MV chain and the frame-latent
        chain run on two worker threads and the join on the calling thread,
        with a one-frame skew: each chain's host fetches and rANS overlap
        the others' device work. All three issue onto the calling thread's
        current stream, which orders their kernels; device tensors pass
        between the threads as they are.

        Returns (x_hat_list, final_dpb), equal bit for bit to folding
        :meth:`decode` frame by frame: the same functions on the same
        inputs, in the same order within each chain.
        """
        m = self.model
        batch = dpb["ref_frame"].shape[0]
        on_stream = self._on_stream()
        mv_pool, y_pool = CtxPool(max_workers=1), CtxPool(max_workers=1)

        def y_shape(bits):
            zh, zw = bits.z_shape
            return (batch, zh * 4, zw * 4, m.N)

        @torch.no_grad()
        def mv_stage(bits, ref_mv_y):
            if isinstance(ref_mv_y, _FutureField):
                ref_mv_y = ref_mv_y.resolve()
            with on_stream():
                q, ratio = bits.q_milli / 1000.0, bits.ratio_centi / 100.0
                mv_z_hat = self._decode_z("mv_coder", bits.streams[4], bits.z_shape, batch)
                params0 = m.mv_fused_params(mv_z_hat, ref_mv_y)
                mv_y_hat = self._dec_four_part(m.mv_coder, y_shape(bits), params0,
                                               bits.streams[0:4])
                mv_hat, mv_feature = m.mv_synthesis(mv_y_hat, ratio, q)
            return mv_y_hat, mv_hat, mv_feature

        @torch.no_grad()
        def y_stage(bits, ref_y):
            if isinstance(ref_y, _FutureField):
                ref_y = ref_y.resolve()
            with on_stream():
                z_hat = self._decode_z("y_coder", bits.streams[9], bits.z_shape, batch)
                params0 = m.frame_fused_params(z_hat, ref_y)
                return self._dec_four_part(m.y_coder, y_shape(bits), params0,
                                           bits.streams[5:9])

        try:
            # Seed the chains from the DPB; each then advances on its own
            # previous output.
            mv_futs, y_futs = [], []
            prev_mv_y, prev_y = dpb.get("ref_mv_y"), dpb.get("ref_y")
            for bits in bits_list:
                f_mv = mv_pool.submit(mv_stage, bits, prev_mv_y)
                mv_futs.append(f_mv)
                prev_mv_y = _FutureField(f_mv, 0)
                f_y = y_pool.submit(y_stage, bits, prev_y)
                y_futs.append(f_y)
                prev_y = _FutureField(f_y, None)

            xs = []
            cur = dpb
            for bits, f_mv, f_y in zip(bits_list, mv_futs, y_futs):
                q, ratio = bits.q_milli / 1000.0, bits.ratio_centi / 100.0
                mv_y_hat, mv_hat, mv_feature = f_mv.result()
                context, _ = m.motion_compensate(cur["ref_frame"], cur.get("ref_feature"),
                                                 mv_hat)
                y_hat = f_y.result()
                x_hat, feature = m.frame_synthesis(y_hat, context, q)
                cur = {
                    "ref_frame": clip(x_hat, 0.0, 1.0),
                    "ref_feature": feature,
                    "ref_mv_feature": mv_feature,
                    "ref_y": y_hat,
                    "ref_mv_y": mv_y_hat,
                    "ref_down_ratio": ratio,
                }
                xs.append(x_hat)
            return xs, cur
        finally:
            # A chain that failed leaves its successors waiting on its
            # future; they raise in turn, and the pools drain.
            mv_pool.shutdown(wait=True)
            y_pool.shutdown(wait=True)


class _FutureField:
    """Lazy view of one element of a future's result, resolved inside the
    consuming chain's own worker (the submitting thread never blocks)."""

    def __init__(self, fut, index):
        self._fut = fut
        self._index = index

    def resolve(self):
        r = self._fut.result()
        return r if self._index is None else r[self._index]
