"""The pass after a conv: its output cast to float32 and laid out NHWC, its
bias added, a residual added, and the activation that follows applied.

``epilogue(y, bias, act, slope, residual)`` takes the NCHW output of a conv
(``ops.precision.conv``) and returns the NHWC float32 tensor that
``models/layers.py``'s convs return, in the plain version's order:

    out = act(y.permute(0, 2, 3, 1).float() + bias + residual)

``act`` is None, ``"relu"`` (``F.relu``) or ``"leaky_relu"`` (flax's
``where(x >= 0, x, slope * x)``); ``bias`` and ``residual`` may be None.

On a CUDA tensor while autograd does not record (``inference_mode``,
``no_grad``, or no operand that requires grad: every coding and eval path)
``epilogue`` launches the hand-written kernel ``tpuvc_torch/csrc/epilogue.cu``
(:func:`epilogue_kernel`), one pass that reads the conv's output once and
writes the result once, and gives the plain version's bits. It replaces no
TPU kernel: XLA fused this epilogue into the conv on the TPU. On a CPU
tensor, and on a card while autograd records (training), it runs
:func:`epilogue_plain`, the separate ops in their order; the kernel has no
backward yet.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "epilogue.cu"
)
_lib = None
_ACTS = {None: 0, "relu": 1, "leaky_relu": 2}


def leaky_relu(x, slope: float = 0.01):
    """flax's ``nn.leaky_relu``: ``where(x >= 0, x, slope * x)``. Its
    gradient at exactly 0 is 1, where ``F.leaky_relu``'s is ``slope``; the
    values are the same."""
    return torch.where(x >= 0, x, slope * x)


def activate(x, act: str | None = None, slope: float = 0.01):
    """The activation after a conv, plain: none, ``F.relu`` or
    :func:`leaky_relu` with ``slope``."""
    if act is None:
        return x
    if act == "relu":
        return F.relu(x)
    if act == "leaky_relu":
        return leaky_relu(x, slope)
    raise ValueError(f"unknown activation {act!r}: none, 'relu' or 'leaky_relu'")


def epilogue_plain(y, bias=None, act=None, slope: float = 0.01, residual=None,
                   dtype=torch.float32):
    """The epilogue as separate PyTorch ops, on any device; the kernel's
    reference. ``dtype`` is the output's (a transposed conv returns its
    input's)."""
    out = y.permute(0, 2, 3, 1).to(dtype)
    if bias is not None:
        out = out + bias
    if residual is not None:
        out = out + residual
    return activate(out, act, slope)


def _get_lib():
    global _lib
    if _lib is None:
        from tpuvc_torch.utils.native import NVCC_FLAGS, build_library, nvcc_path

        lib = ctypes.CDLL(
            build_library("tpuvc_epilogue", [_SRC], [nvcc_path(), *NVCC_FLAGS])
        )
        fn = lib.tpuvc_epilogue
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def build_kernel() -> None:
    """Compile (or load the cached) epilogue kernel library now."""
    _get_lib()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill their memory span once each, in some
    order of its dimensions."""
    span = 1
    for stride, size in sorted((st, s) for s, st in zip(t.shape, t.stride()) if s > 1):
        if stride != span:
            return False
        span *= size
    return True


def _standard(t: torch.Tensor) -> bool:
    """Whether ``t`` has the strides of a fresh contiguous tensor of its
    shape (size-one dimensions included)."""
    span = 1
    for size, stride in zip(reversed(t.shape), reversed(t.stride())):
        if stride != span:
            return False
        span *= size
    return True


def epilogue_kernel(y, bias=None, act=None, slope: float = 0.01, residual=None):
    """Launch the CUDA epilogue kernel on ``y``, a conv's dense NCHW output
    (bfloat16 or float32) on a card: the NHWC float32 result with the plain
    version's bits and strides. ``bias`` (C,) and ``residual`` (the
    output's shape) are float32 on the same card.

    The result is laid out as ``y`` (as the plain cast lays it out), and an
    elementwise activation keeps that layout, so without a residual one
    launch does it all in either of cuDNN's layouts (channels-last memory or
    NCHW). So it does with a residual where the NHWC view of ``y`` and the
    residual have a fresh contiguous tensor's strides (cuDNN's channels-last
    output). Otherwise the launch casts and adds the bias, and the residual
    add and the activation follow as the plain ops, which then give the
    plain version's strides: for a residual beside an NCHW output (as
    SPyNet's 2-channel flow conv gives it), a strided residual, and an
    activation after an NCHW output with a size-one dimension (the plain
    activation may give that dimension another stride). Such a launch
    counts in ``partial_launches``. Raises on anything the kernel does not
    take."""
    if y.device.type != "cuda" or y.dim() != 4:
        raise ValueError(f"epilogue_kernel takes a 4-d tensor on a CUDA card, got "
                         f"{tuple(y.shape)} on {y.device}")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"epilogue_kernel takes bfloat16 or float32, got {y.dtype}")
    if not _dense(y):
        raise ValueError(f"epilogue_kernel takes a dense tensor, got strides {y.stride()}")
    code = _ACTS.get(act)
    if code is None and act is not None:
        raise ValueError(f"unknown activation {act!r}: none, 'relu' or 'leaky_relu'")
    yv = y.permute(0, 2, 3, 1)
    C = yv.shape[3]
    for name, t, shape in (("bias", bias, (C,)), ("residual", residual, yv.shape)):
        if t is not None and (t.device != y.device or t.dtype != torch.float32
                              or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"epilogue_kernel takes a float32 {name} of shape "
                             f"{tuple(shape)} on {y.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if bias is not None and not bias.is_contiguous():
        bias = bias.contiguous()
    if _standard(yv):
        fold = residual is None or _standard(residual)
    else:
        fold = residual is None and (act is None or 1 not in yv.shape)
    out = torch.empty_like(yv, dtype=torch.float32)
    if out.numel() == 0:
        return out
    index = y.device.index if y.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        rc = _get_lib().tpuvc_epilogue(
            y.data_ptr(), int(y.dtype == torch.bfloat16),
            None if bias is None else bias.data_ptr(),
            residual.data_ptr() if fold and residual is not None else None,
            out.data_ptr(), out.numel(), C, yv.stride(3) if C > 1 else 1,
            code if fold else 0, slope, _sm_count(index), stream,
        )
    if rc != 0:
        raise RuntimeError(f"epilogue kernel launch failed: cudaError {rc}")
    epilogue_kernel.launches += 1
    if fold:
        epilogue_kernel.act_launches += act is not None
        return out
    epilogue_kernel.partial_launches += 1
    return activate(out if residual is None else out + residual, act, slope)


#: Kernel launches since the count was last set to 0, those of them that
#: applied an activation, and those that left the residual add and the
#: activation to the plain ops.
epilogue_kernel.launches = 0
epilogue_kernel.act_launches = 0
epilogue_kernel.partial_launches = 0


def epilogue(y, bias=None, act=None, slope: float = 0.01, residual=None,
             dtype=torch.float32):
    """``act(y.permute(0, 2, 3, 1).to(dtype) + bias + residual)`` for the
    NCHW conv output ``y``: :func:`epilogue_plain` on a CPU tensor and while
    autograd records, else the kernel (which launches or raises). Where
    nothing is left to compute (no bias, residual or activation, ``y``
    already in ``dtype``) the NHWC view itself, as the plain version
    returns it."""
    if bias is None and residual is None and act is None and y.dtype == dtype:
        return y.permute(0, 2, 3, 1)
    if y.device.type == "cpu" or (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (y, bias, residual))):
        return epilogue_plain(y, bias, act, slope, residual, dtype)
    if dtype != torch.float32:
        raise ValueError(f"epilogue_kernel writes float32, asked for {dtype}")
    return epilogue_kernel(y, bias, act, slope, residual)
