"""Compute-dtype policy for the codec transforms (port of tpuvc.ops.precision).

Convolutions and GDN's channel mixing run in the policy dtype (bfloat16 under
:func:`mixed_precision`); everything between them — flow arithmetic, warp
coordinates, entropy parameters, likelihoods — stays float32. Parameters stay
float32, so one checkpoint serves both modes.

PyTorch runs eagerly, so the policy is read when a layer *runs* (tpuvc reads
it at trace time). It is a ``contextvars`` variable: worker threads see the
submitter's policy only through :class:`tpuvc_torch.coder.parallel.CtxPool`.

Encoder and decoder must compute identically (the decoder re-estimates flow
from reconstructions), so coding on CUDA also needs :func:`set_deterministic`.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_COMPUTE_DTYPE: contextvars.ContextVar = contextvars.ContextVar(
    "tpuvc_torch_compute_dtype", default=None
)


def compute_dtype():
    """The active compute dtype for conv/matmul layers, or None (float32)."""
    return _COMPUTE_DTYPE.get()


@contextlib.contextmanager
def set_compute_dtype(dtype):
    """Set the layer compute dtype for the enclosed code (None to disable)."""
    token = _COMPUTE_DTYPE.set(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE.reset(token)


def mixed_precision():
    """bfloat16 layer compute, float32 everything else (see module doc)."""
    return set_compute_dtype(torch.bfloat16)


def policy_from_name(name: str):
    """Context manager for a config-level dtype name.

    "float32"/"f32"/"" -> float32 policy; "bfloat16"/"bf16" -> mixed precision.
    """
    name = (name or "float32").lower()
    if name in ("float32", "f32", "fp32"):
        return set_compute_dtype(None)
    if name in ("bfloat16", "bf16"):
        return set_compute_dtype(torch.bfloat16)
    raise ValueError(f"unknown compute dtype: {name}")


def set_deterministic() -> None:
    """Process-wide settings that make encode and decode compute alike on CUDA.

    cuDNN picks its algorithms by fixed heuristics (no autotuning race) and
    only deterministic ones; TF32 is off, so the float32 parts of the policy
    really are float32.
    """
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
