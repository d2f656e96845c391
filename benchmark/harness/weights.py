"""Weights made by the benchmark from the seed, on the device, in a few
large draws.

The reference model of a configuration is built on the device with its
leaves uninitialised; every module's ``reset_parameters(draws)`` sets the
constant leaves and registers the random ones with a :class:`Draws`, which
then fills all truncated-normal leaves from one draw and all uniform
leaves from another. The same seed gives the same weights on the same
device, so the program is handed them at set-up and the reference makes
them again for itself after the window.
"""

from __future__ import annotations

import torch
from torch import nn


def stream_seed(seed: int, stream: int) -> int:
    """The generator seed of one purpose (a model, the frames) of a run."""
    return (16 * seed + stream) % 2**63


class Draws:
    def __init__(self):
        self._normal: list = []
        self._uniform: list = []

    def trunc_normal(self, t: torch.Tensor, std: float) -> None:
        """``t`` ~ std * N(0, 1) truncated at +-2."""
        self._normal.append((t, std))

    def uniform(self, t: torch.Tensor, lo: float, hi: float) -> None:
        self._uniform.append((t, lo, hi))

    @torch.no_grad()
    def fill(self, generator: torch.Generator, device) -> None:
        n = sum(t.numel() for t, _ in self._normal)
        flat = torch.empty(n, device=device)
        nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator)
        off = 0
        for t, std in self._normal:
            k = t.numel()
            t.copy_(flat[off:off + k].view(t.shape) * std)
            off += k
        n = sum(t.numel() for t, _, _ in self._uniform)
        flat = torch.rand(n, generator=generator, device=device)
        off = 0
        for t, lo, hi in self._uniform:
            k = t.numel()
            t.copy_(lo + (hi - lo) * flat[off:off + k].view(t.shape))
            off += k


def seeded(build, seed: int, device, heads: dict | None = None,
           stream: int = 0) -> nn.Module:
    """``build()`` on ``device`` with the weights of ``seed`` (``stream``
    tells the models of one configuration apart). ``heads``:
    {module name: scale} of the convolutions that the configuration gives
    a scaled lecun-normal draw in place of their zero start."""
    heads = heads or {}
    with torch.device(device):
        model = build()
    model.to(device).eval()
    draws = Draws()
    for name, m in model.named_modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is None:
            continue
        if name in heads:
            reset(draws, head_scale=heads[name])
        else:
            reset(draws)
    missing = set(heads) - {name for name, _ in model.named_modules()}
    if missing:
        raise KeyError(f"heads not in the model: {sorted(missing)}")
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    draws.fill(gen, device)
    return model


def states(models: dict) -> dict:
    """{name: state dict} of ``models``: what the program is handed."""
    return {k: {n: t.detach() for n, t in m.state_dict().items()} for k, m in models.items()}
