"""ELIC intra (I-frame) codec: checkerboard + uneven channel-group context
(port of tpuvc.models.elic).

N=192, M=320 transforms with attention, uneven channel groups
(16, 16, 32, 64, 192), and per-group entropy parameters from
[checkerboard spatial context | channel context from previous groups |
hyper prior]. The five groups are a sequential dependency (the channel
context reads decoded groups); within a group, anchors are coded with zero
spatial context, then non-anchors with the decoded anchors as context.

z is rounded straight-through in the likelihood path and around the
factorized prior's medians in the stream path; both sides of the codec
agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuvc_torch import resolve_device
from tpuvc_torch.entropy.bottleneck import FactorizedBottleneck
from tpuvc_torch.entropy.emath import likelihood_to_bits
from tpuvc_torch.entropy.gaussian import GaussianConditional
from tpuvc_torch.entropy.quant import quantize, ste_round
from tpuvc_torch.models.cond_elic import GroupCoder, _ChannelContext, _EntropyParams
from tpuvc_torch.models.layers import (
    AttentionBlock,
    Conv,
    Deconv,
    ResidualBottleneckBlock,
    init_weights,
)
from tpuvc_torch.ops.checkerboard import CheckerboardConv, keep_anchor, keep_non_anchor
from tpuvc_torch.ops.precision import set_deterministic


class ELIC(nn.Module):
    """``generator`` draws the initial weights (tpuvc's initialisers); a
    trained model loads a state dict instead (tpuvc_torch.utils.convert)."""

    def __init__(self, N: int = 192, M: int = 320,
                 groups: tuple[int, ...] = (16, 16, 32, 64, 192),
                 generator: torch.Generator | None = None):
        super().__init__()
        assert sum(groups) == M, (groups, M)
        self.N, self.M, self.groups = N, M, tuple(groups)

        def rbb3():
            return [ResidualBottleneckBlock(N) for _ in range(3)]

        self.g_a_layers = nn.ModuleList(
            [Conv(3, N, kernel=5, stride=2)] + rbb3()
            + [Conv(N, N, kernel=5, stride=2)] + rbb3()
            + [AttentionBlock(N), Conv(N, N, kernel=5, stride=2)] + rbb3()
            + [Conv(N, M, kernel=5, stride=2), AttentionBlock(M)]
        )
        self.g_s_layers = nn.ModuleList(
            [AttentionBlock(M), Deconv(M, N, kernel=5, stride=2)] + rbb3()
            + [Deconv(N, N, kernel=5, stride=2), AttentionBlock(N)] + rbb3()
            + [Deconv(N, N, kernel=5, stride=2)] + rbb3()
            + [Deconv(N, 3, kernel=5, stride=2)]
        )
        self.h_a_layers = nn.ModuleList([
            Conv(M, N, kernel=3, stride=1),
            Conv(N, N, kernel=5, stride=2),
            Conv(N, N, kernel=5, stride=2),
        ])
        self.h_s_layers = nn.ModuleList([
            Deconv(N, M, kernel=5, stride=2),
            Deconv(M, M * 3 // 2, kernel=5, stride=2),
            Conv(M * 3 // 2, M * 2, kernel=3, stride=1),
        ])
        self.entropy_parameters = nn.ModuleList(
            _EntropyParams((4 if i == 0 else 6) * M, M, 2 * g)
            for i, g in enumerate(self.groups)
        )
        self.channel_context_models = nn.ModuleList(
            _ChannelContext(sum(self.groups[:i]), N, M)
            for i in range(1, len(self.groups))
        )
        self.context_prediction_models = nn.ModuleList(
            CheckerboardConv(g, M * 2, kernel=5) for g in self.groups
        )
        self.entropy_bottleneck = FactorizedBottleneck(channels=N)
        self.gaussian = GaussianConditional()
        if generator is not None:
            init_weights(self, generator)

    def g_a(self, x):
        for layer in self.g_a_layers:
            x = layer(x)
        return x

    def g_s(self, y_hat):
        for layer in self.g_s_layers:
            y_hat = layer(y_hat)
        return y_hat

    def h_a(self, y):
        a0, a1, a2 = self.h_a_layers
        return a2(F.relu(a1(F.relu(a0(y)))))

    def h_s(self, z_hat):
        s0, s1, s2 = self.h_s_layers
        return s2(F.relu(s1(F.relu(s0(z_hat)))))

    def analysis(self, x):
        y = self.g_a(x)
        return y, self.h_a(y)

    def hyper_params(self, z_hat):
        return self.h_s(z_hat)

    def group_params(self, i: int, hyper_params, prev_groups_hat, y_anchor_hat):
        """Entropy parameters (scales, means) of group ``i``.

        ``y_anchor_hat``: group i's reconstruction with its non-anchor cells
        zeroed (zeros for the anchor phase); ``prev_groups_hat``: the
        concatenated reconstructions of groups < i (ignored for i == 0).
        The spatial context is zeroed at anchor cells."""
        ctx = keep_non_anchor(self.context_prediction_models[i](y_anchor_hat))
        if i == 0:
            inp = torch.cat([ctx, hyper_params], dim=-1)
        else:
            channel_ctx = self.channel_context_models[i - 1](prev_groups_hat)
            inp = torch.cat([ctx, channel_ctx, hyper_params], dim=-1)
        scales, means = torch.chunk(self.entropy_parameters[i](inp), 2, dim=-1)
        return scales, means

    def forward(self, x, mode: str = "noise",
                generator: torch.Generator | None = None, stage2: bool = False):
        """Single pass with the checkerboard approximation. mode: 'noise'
        (training, needs ``generator``), 'ste' or 'dequantize'. ``stage2``
        quantizes the groups around their means and feeds those to g_s and
        the channel context."""
        y, z = self.analysis(x)
        _, z_lik = self.entropy_bottleneck(z, mode, generator=generator)
        likelihoods = {"z": z_lik}
        hyper = self.hyper_params(ste_round(z))

        groups_hat = []
        for i, curr_y in enumerate(torch.split(y, self.groups, dim=-1)):
            curr_y_hat = quantize(curr_y, mode, generator=generator)
            prev = torch.cat(groups_hat, dim=-1) if i > 0 else None
            scales, means = self.group_params(i, hyper, prev, keep_anchor(curr_y_hat))
            _, likelihoods[f"y_{i}"] = self.gaussian(
                curr_y, scales, means=means, mode=mode, generator=generator
            )
            groups_hat.append(ste_round(curr_y - means) + means if stage2 else curr_y_hat)

        y_hat = torch.cat(groups_hat, dim=-1) if stage2 else ste_round(y)
        return {"x_hat": self.g_s(y_hat), "likelihoods": likelihoods}

    def bits(self, likelihoods: dict) -> torch.Tensor:
        return sum(likelihood_to_bits(p) for p in likelihoods.values())

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()


class ELICCoder(GroupCoder):
    """Real-bitstream compress/decompress for ELIC.

    z is coded around the factorized prior's medians; each group in two
    checkerboard phases around its means, the channel context always from
    *decoded* groups, so encoder and decoder see the same context. A stream
    set is [a0, n0, a1, n1, ...] (anchor and non-anchor string per group)
    and the z string.

    ``device`` defaults to ``cuda``; the model moves there. Inputs are NHWC
    float32 frames whose sides divide by 64.
    """

    def __init__(self, module: ELIC, device=None):
        device = resolve_device(device)
        if device.type == "cuda":
            set_deterministic(device)
        super().__init__(module.to(device).eval())

    def _code_groups(self, y, hyper, per_sample=False, submit=False):
        """Every group in order: -> (y_hat, [[anchor, non-anchor] per group])."""
        groups_hat, strings = [], []
        for i, curr_y in enumerate(torch.split(y, self.module.groups, dim=-1)):
            g_hat, strs = self._code_group(
                i, curr_y, hyper, self._prev(groups_hat, hyper),
                per_sample=per_sample, submit=submit,
            )
            groups_hat.append(g_hat)
            strings.append(strs)
        return torch.cat(groups_hat, dim=-1), strings

    @torch.no_grad()
    def compress(self, x) -> dict:
        """The whole batch in one stream set:
        -> {"strings": [y_strings, z_string], "shape": (zh, zw), "y_hat"}."""
        m = self.module
        y, z = m.analysis(x.to(self.device))
        z_hat, z_string, z_shape = self._code_z(z)
        y_hat, strings = self._code_groups(y, m.hyper_params(z_hat))
        y_strings = [s for pair in strings for s in pair]
        return {"strings": [y_strings, z_string], "shape": z_shape, "y_hat": y_hat}

    @torch.no_grad()
    def synthesize(self, y_hat):
        """The decoded image from the quantized latent: the encoder-side
        reconstruction, equal to what decompress gives."""
        return self.module.g_s(y_hat)

    @torch.no_grad()
    def compress_batch_async(self, x) -> dict:
        """Batched compress with one independently decodable stream set per
        frame and the host phases on workers: every device stage is issued
        without waiting for a symbol fetch. decompress_batch must replay
        the same batch size.

        -> {"strings_resolve", "shape", "y_hat"}; ``strings_resolve()``
        returns [(y_strings, z_string)] * B."""
        m = self.module
        y, z = m.analysis(x.to(self.device))
        b = z.shape[0]
        z_hat, z_fut = self._code_z_per_sample(z)
        y_hat, futs = self._code_groups(y, m.hyper_params(z_hat), per_sample=True, submit=True)

        def strings_resolve():
            per_group = [(a.result(), n.result()) for a, n in futs]
            z_strings = z_fut.result()
            return [
                ([s for a, n in per_group for s in (a[j], n[j])], z_strings[j])
                for j in range(b)
            ]

        return {"strings_resolve": strings_resolve, "shape": tuple(z.shape[1:3]),
                "y_hat": y_hat}

    def compress_batch(self, x) -> dict:
        """Blocking variant of compress_batch_async:
        -> {"strings": [(y_strings, z_string)] * B, "shape", "y_hat"}."""
        out = self.compress_batch_async(x)
        out["strings"] = out.pop("strings_resolve")()
        return out

    @torch.no_grad()
    def decompress_batch(self, per_frame, shape):
        """Inverse of compress_batch: [(y_strings, z_string)] * B in, the
        batch's decoded images out (the encoder's batch shapes)."""
        from tpuvc_torch.coder.parallel import run_steps

        hyper = self.module.hyper_params(
            run_steps(self._decode_z([f[1] for f in per_frame], shape))[0]
        )
        streams = [
            [[f[0][2 * i] for f in per_frame], [f[0][2 * i + 1] for f in per_frame]]
            for i in range(len(self.module.groups))
        ]
        y_hat = run_steps(self._decode_groups(hyper, streams, per_sample=True))[0]
        return self.module.g_s(y_hat)

    @torch.no_grad()
    def decompress(self, strings, shape, batch: int = 1):
        """Inverse of compress: (y_strings, z_string) -> decoded images."""
        from tpuvc_torch.coder.parallel import run_steps

        y_strings, z_string = strings
        z_hat, _, _ = self._code_z(None, z_string=z_string, z_shape=shape, batch=batch)
        streams = [y_strings[2 * i : 2 * i + 2] for i in range(len(self.module.groups))]
        y_hat = run_steps(self._decode_groups(self.module.hyper_params(z_hat), streams))[0]
        return self.module.g_s(y_hat)
