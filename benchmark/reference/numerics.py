"""Operand precision of the reference's layers.

By default every layer computes in float32 with TF32 off (:func:`strict`).
Under :func:`control` the operands of the layers that the configurations
run in bfloat16 (convolutions, transposed convolutions and GDN's channel
mixing) are rounded to fp8 (e4m3, one scale per tensor from its largest
magnitude, as fp8 GEMMs are fed), and the float32 matrix products and
convolutions may use TF32: the nearest precision below each layer's own.
That is the benchmark's control, which its comparison has to reject.
"""

from __future__ import annotations

import contextlib

import torch

_FP8_MAX = 448.0  # largest finite float8_e4m3fn


class _State:
    fp8 = False


def strict() -> None:
    """float32 matrix products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def control():
    """fp8 operands for the bfloat16 layers, TF32 for the float32 ones."""
    before = (_State.fp8, torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    _State.fp8 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (_State.fp8, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a reduced-precision layer would see it (float32 values)."""
    if not _State.fp8 or x.device.type == "meta":
        return x
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
