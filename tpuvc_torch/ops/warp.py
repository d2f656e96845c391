"""Bilinear backward warp (motion compensation) for NHWC tensors.

Port of tpuvc.ops.warp. ``warp`` takes the same compat modes:

- ``exact``: out[y, x] = img[y + dy, x + dx], bilinear, border clamp;
- ``lhbdc``: the displacement scaled by W/(W-1), H/(H-1) (the v1 codec's
  grid_sample normalisation);
- ``flexrate``: a half-pixel shift and zero padding, computed as an exact
  warp over the frame with a one-pixel ring of zeros.

On a CUDA tensor ``warp`` launches the hand-written kernel
``tpuvc_torch/csrc/warp.cu`` (:func:`warp_kernel`), which replaces tpuvc's
Pallas band kernel. On a CPU tensor it runs :func:`warp_plain`, the PyTorch
transcription of tpuvc's XLA formulation (``warp_pallas._warp_xla``). Any
other device raises: nothing falls back to the plain version quietly.
Gradients on CUDA go through autograd of the plain version.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "warp.cu"
)
_lib = None


def _scales(compat: str, H: int, W: int) -> tuple[float, float, bool]:
    """(sx, sy, zero) for a compat mode; flexrate also shifts the flow."""
    if compat == "lhbdc":
        return W / (W - 1.0), H / (H - 1.0), False
    if compat in ("exact", "flexrate"):
        return 1.0, 1.0, compat == "flexrate"
    raise ValueError(f"unknown warp compat mode: {compat}")


def _warp_plain_core(img, flow, sx: float, sy: float) -> torch.Tensor:
    """Gather formulation of tpuvc's ``_warp_xla``, op for op (border clamp)."""
    B, H, W, C = img.shape
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)
    x = torch.clamp(xs[None, None, :] + flow[..., 0] * sx, 0.0, W - 1.0)
    y = torch.clamp(ys[None, :, None] + flow[..., 1] * sy, 0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    flat = img.reshape(B, H * W, C)

    def gather(yi, xi):
        idx = (yi * W + xi).reshape(B, H * W, 1).expand(B, H * W, C)
        return torch.gather(flat, 1, idx).reshape(B, H, W, C)

    w00 = ((1.0 - fy) * (1.0 - fx))[..., None]
    w01 = ((1.0 - fy) * fx)[..., None]
    w10 = (fy * (1.0 - fx))[..., None]
    w11 = (fy * fx)[..., None]
    return (
        w00 * gather(y0i, x0i)
        + w01 * gather(y0i, x1i)
        + w10 * gather(y1i, x0i)
        + w11 * gather(y1i, x1i)
    )


def _warp_plain_sampled(img, flow, sx: float, sy: float, zero: bool):
    """What the kernel computes, in plain PyTorch: with ``zero``, an exact
    warp over the frame ringed by zeros (the flow already shifted)."""
    if not zero:
        return _warp_plain_core(img, flow, sx, sy)
    imgp = F.pad(img, (0, 0, 1, 1, 1, 1))
    flowp = F.pad(flow.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    return _warp_plain_core(imgp, flowp.permute(0, 2, 3, 1), sx, sy)[:, 1:-1, 1:-1]


def warp_plain(img: torch.Tensor, flow: torch.Tensor,
               compat: str = "exact") -> torch.Tensor:
    """Plain PyTorch warp on any device; the kernel's reference."""
    B, H, W, C = img.shape
    assert tuple(flow.shape) == (B, H, W, 2), (img.shape, flow.shape)
    sx, sy, zero = _scales(compat, H, W)
    return _warp_plain_sampled(img, flow - 0.5 if zero else flow, sx, sy, zero)


def _get_lib():
    global _lib
    if _lib is None:
        from tpuvc_torch.utils.native import NVCC_FLAGS, build_library, nvcc_path

        lib = ctypes.CDLL(
            build_library("tpuvc_warp", [_SRC], [nvcc_path(), *NVCC_FLAGS])
        )
        fn = lib.tpuvc_warp_bilinear_nhwc
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def build_kernel() -> None:
    """Compile (or load the cached) warp kernel library now."""
    _get_lib()


def warp_kernel(img: torch.Tensor, flow: torch.Tensor, sx: float = 1.0,
                sy: float = 1.0, zero: bool = False) -> torch.Tensor:
    """Launch the CUDA warp kernel: img (B,H,W,C), flow (B,H,W,2), both
    contiguous float32 on one CUDA device. ``zero`` is the flexrate mode:
    the flow shifted by -0.5 inside the kernel, then sampled over a ring of
    zeros (coordinates of the ringed frame) instead of clamped to the
    border. Raises on anything the kernel does not take."""
    if img.device.type != "cuda" or flow.device != img.device:
        raise ValueError(
            f"warp_kernel needs img and flow on one CUDA device, got "
            f"{img.device} and {flow.device}"
        )
    if img.dtype != torch.float32 or flow.dtype != torch.float32:
        raise ValueError(f"warp_kernel takes float32, got {img.dtype}, {flow.dtype}")
    if img.dim() != 4 or flow.dim() != 4:
        raise ValueError(f"warp_kernel takes NHWC, got {tuple(img.shape)}")
    B, H, W, C = img.shape
    if tuple(flow.shape) != (B, H, W, 2):
        raise ValueError(f"flow shape {tuple(flow.shape)} != {(B, H, W, 2)}")
    if not (img.is_contiguous() and flow.is_contiguous()):
        raise ValueError("warp_kernel takes contiguous img and flow")
    if B * H * W * max(C, 2) >= 2**31:
        raise ValueError(f"warp_kernel indexes in int32; {tuple(img.shape)} is too large")
    if max(B, H) > 65535:
        raise ValueError(f"warp_kernel launches over B and H; {(B, H)} exceeds 65535")
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = _get_lib().tpuvc_warp_bilinear_nhwc(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            B, H, W, C, sx, sy, int(zero), stream,
        )
    if rc != 0:
        raise RuntimeError(f"warp kernel launch failed: cudaError {rc}")
    warp_kernel.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
warp_kernel.launches = 0


class _WarpKernelFn(torch.autograd.Function):
    """Kernel forward; backward by autograd of the plain formulation."""

    @staticmethod
    def forward(ctx, img, flow, sx, sy, zero):
        ctx.save_for_backward(img, flow)
        ctx.args = (sx, sy, zero)
        return warp_kernel(img, flow, sx, sy, zero)

    @staticmethod
    def backward(ctx, grad):
        img, flow = ctx.saved_tensors
        sx, sy, zero = ctx.args
        need_img, need_flow = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            i = img.detach().requires_grad_(need_img)
            f = flow.detach().requires_grad_(need_flow)
            out = _warp_plain_sampled(i, f - 0.5 if zero else f, sx, sy, zero)
            inputs = [t for t in (i, f) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, grad))
        gi = next(grads) if need_img else None
        gf = next(grads) if need_flow else None
        return gi, gf, None, None, None


def warp(img: torch.Tensor, flow: torch.Tensor, compat: str = "exact") -> torch.Tensor:
    """Backward-warp ``img`` (B,H,W,C) by ``flow`` (B,H,W,2: dx, dy).

    CPU tensors take :func:`warp_plain`; CUDA tensors the kernel.
    """
    B, H, W, C = img.shape
    assert tuple(flow.shape) == (B, H, W, 2), (img.shape, flow.shape)
    if img.device.type == "cpu":
        return warp_plain(img, flow, compat)
    sx, sy, zero = _scales(compat, H, W)
    img, flow = img.contiguous(), flow.contiguous()
    if torch.is_grad_enabled() and (img.requires_grad or flow.requires_grad):
        return _WarpKernelFn.apply(img, flow, sx, sy, zero)
    return warp_kernel(img, flow, sx, sy, zero)
