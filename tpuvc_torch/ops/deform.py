"""Modulated deformable convolution for NHWC tensors (port of tpuvc.ops.deform).

Semantics are torchvision's ``deform_conv2d``: every output pixel samples
its K*K taps at ``p + tap base + offset`` with bilinear interpolation and
*zero* padding outside the frame, multiplies each sample by its modulation
mask, and contracts the samples with the weights of its group (weight groups
= offset groups).

On a CUDA tensor :func:`deform_conv2d` launches the hand-written kernel
``tpuvc_torch/csrc/deform.cu`` (:func:`deform_kernel`), which replaces
tpuvc's fused Pallas band kernel and, like it, computes in float32 whatever
the compute-dtype policy. On a CPU tensor it runs :func:`deform_plain`, the
PyTorch transcription of tpuvc's tap-unrolled formulation
``_deform_taps(force_xla=True)``. Any other device raises: nothing falls back
to the plain version quietly. Gradients on CUDA go through autograd of the
plain version, as tpuvc's custom VJP goes through its XLA formulation; it
samples whole pixels by index, so under PyTorch's deterministic algorithms
(training) its backward adds each pixel's samples in a fixed order and
gives the same bits every run.

``y0`` (every entry point's last argument, 0 by default) computes only
output rows ``[y0, y0 + H_out)``, ``H_out`` being the offsets' height: the
offsets and masks hold just those rows, x all of its H rows, taps sample
the whole frame and the zero padding is the frame's. The kernel's rows equal
those rows of a whole-frame launch bit for bit (a rank of an H-sharded
forward, tpuvc_torch.parallel.spatial).
"""

from __future__ import annotations

import ctypes
import os

import torch
from torch import nn

from tpuvc_torch.models.layers import lecun_normal_

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "deform.cu"
)
_lib = None


def _sample_zero_pad(img: torch.Tensor, flow: torch.Tensor, y0: int = 0) -> torch.Tensor:
    """Bilinear sample of img (B,H,W,C) at (col + flow_x, row + flow_y), with
    zero padding outside the frame (tpuvc's ``_warp_zero_pad``, op for op),
    for output rows ``[y0, y0 + flow rows)``."""
    B, H, W, C = img.shape
    Ho = flow.shape[1]
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(y0, y0 + Ho, dtype=flow.dtype, device=flow.device)
    x = xs[None, None, :] + flow[..., 0]
    y = ys[None, :, None] + flow[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(B * H * W, C)
    base = torch.arange(B, device=img.device).view(B, 1, 1) * (H * W)

    def corner(yi, xi, w):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.clamp(xi, 0, W - 1).long()
        yc = torch.clamp(yi, 0, H - 1).long()
        # whole pixels by index: under deterministic algorithms the
        # gradient's index_add sums each pixel's samples in a fixed order
        v = flat.index_select(0, (base + yc * W + xc).reshape(-1)).reshape(B, Ho, W, C)
        return v * (w * valid)[..., None]

    return (
        corner(y0, x0, (1 - fy) * (1 - fx))
        + corner(y0, x0 + 1, (1 - fy) * fx)
        + corner(y0 + 1, x0, fy * (1 - fx))
        + corner(y0 + 1, x0 + 1, fy * fx)
    )


def _check_shapes(x, offsets, masks, weight, groups, kernel, y0: int = 0):
    B, H, W, C = x.shape
    T = kernel * kernel
    Ho = offsets.shape[1] if offsets.dim() == 4 else -1
    C_out, Cg = weight.shape[:2]
    if C % groups or C_out % groups or Cg != C // groups:
        raise ValueError(
            f"deform: {C} input and {C_out} output channels do not split into "
            f"{groups} groups of weight {tuple(weight.shape)}"
        )
    if tuple(weight.shape[2:]) != (kernel, kernel):
        raise ValueError(f"deform: weight {tuple(weight.shape)} is not {kernel}x{kernel}")
    if tuple(offsets.shape) != (B, Ho, W, groups * T * 2) or not 0 <= y0 <= y0 + Ho <= H:
        raise ValueError(f"deform: offsets {tuple(offsets.shape)} at row {y0} do not fit a "
                         f"deform of {tuple(x.shape)}: {(B, 'H_out', W, groups * T * 2)} with "
                         f"0 <= y0, y0 + H_out <= {H}")
    if masks is not None and tuple(masks.shape) != (B, Ho, W, groups * T):
        raise ValueError(f"deform: masks {tuple(masks.shape)} != {(B, Ho, W, groups * T)}")


def deform_plain(x, offsets, masks, weight, bias, groups: int,
                 kernel: int = 3, y0: int = 0) -> torch.Tensor:
    """Plain PyTorch modulated deformable conv on any device; the kernel's
    reference.

    x (B,H,W,C); offsets (B,H,W,G*K*K*2), (dy, dx) per (group, tap) with tap
    k = ky*K + kx (torchvision's layout); masks (B,H,W,G*K*K) or None;
    weight (C_out, C//G, K, K), output slice g taking input slice g; bias
    (C_out,) or None. Taps unrolled, the group contraction per tap, the
    bias added after, all in float32. With ``y0``, offsets and masks of
    H_out rows give output rows ``[y0, y0 + H_out)``.
    """
    _check_shapes(x, offsets, masks, weight, groups, kernel, y0)
    B, H, W, C = x.shape
    Ho = offsets.shape[1]
    K, G = kernel, groups
    T = K * K
    Cg = C // G
    C_out = weight.shape[0]
    Og = C_out // G
    xg = x.reshape(B, H, W, G, Cg).permute(0, 3, 1, 2, 4).reshape(B * G, H, W, Cg)
    off = offsets.reshape(B, Ho, W, G, T, 2).permute(0, 3, 1, 2, 4, 5)
    off = off.reshape(B * G, Ho, W, T, 2)
    if masks is not None:
        m = masks.reshape(B, Ho, W, G, T).permute(0, 3, 1, 2, 4).reshape(B * G, Ho, W, T)
    else:
        m = torch.ones(off.shape[:-1], dtype=x.dtype, device=x.device)
    # (C_out, Cg, K, K) -> per-tap grouped weights (T, Cg, G, Og)
    wk = weight.reshape(G, Og, Cg, T).permute(3, 2, 0, 1)
    pad = K // 2
    acc = torch.zeros((B, G, Ho, W, Og), dtype=x.dtype, device=x.device)
    for k in range(T):
        ky, kx = divmod(k, K)
        # torchvision offsets are (dy, dx); the sampler takes (dx, dy).
        flow = torch.stack(
            [off[..., k, 1] + (kx - pad), off[..., k, 0] + (ky - pad)], dim=-1
        )
        sampled = _sample_zero_pad(xg, flow, y0) * m[..., k][..., None]
        sampled = sampled.reshape(B, G, Ho, W, Cg)
        acc = acc + torch.einsum("bghwc,cgo->bghwo", sampled, wk[k])
    out = acc.permute(0, 2, 3, 1, 4).reshape(B, Ho, W, C_out)
    if bias is not None:
        out = out + bias
    return out


def _get_lib():
    global _lib
    if _lib is None:
        from tpuvc_torch.utils.native import NVCC_FLAGS, build_library, nvcc_path

        lib = ctypes.CDLL(
            build_library("tpuvc_deform", [_SRC], [nvcc_path(), *NVCC_FLAGS])
        )
        fn = lib.tpuvc_deform_conv_nhwc
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        _lib = lib
    return _lib


def build_kernel() -> None:
    """Compile (or load the cached) deform kernel library now."""
    _get_lib()


def lane_width(Cg: int, x_ptr: int) -> int:
    """Channels per lane, as the kernel picks them (csrc/deform.cu,
    ``tpuvc_deform_conv_nhwc``): float4 quads where the group width divides
    by 4 and x starts on a 16-byte boundary, else one channel."""
    return 4 if Cg % 4 == 0 and x_ptr % 16 == 0 else 1


def outputs_per_lane(Cg: int, Og: int, x_ptr: int) -> int:
    """Output channels each lane accumulates, as the kernel counts them
    (csrc/deform.cu, ``tpuvc_deform_conv_nhwc``): a group's outputs over
    its lanes. Above 2 the launch takes the ``<V, MAXO>`` instance."""
    per_group = Cg // lane_width(Cg, x_ptr)
    return -(-Og // per_group)


def deform_kernel(x, offsets, masks, weight, bias, groups: int,
                  kernel: int = 3, y0: int = 0) -> torch.Tensor:
    """Launch the CUDA deform kernel (arguments as :func:`deform_plain`;
    masks and bias required): output rows [y0, y0 + H_out), (B, H_out, W,
    C_out), H_out the offsets' height. All tensors float32 on one CUDA
    device. Raises on anything the kernel does not take."""
    tensors = (x, offsets, masks, weight, bias)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(
            "deform_kernel needs every tensor on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"deform_kernel takes float32, got {[t.dtype for t in tensors]}")
    if x.dim() != 4:
        raise ValueError(f"deform_kernel takes NHWC, got {tuple(x.shape)}")
    _check_shapes(x, offsets, masks, weight, groups, kernel, y0)
    B, H, W, C = x.shape
    Ho = offsets.shape[1]
    G, K = groups, kernel
    C_out, Cg = weight.shape[:2]
    Og = C_out // G
    if tuple(bias.shape) != (C_out,):
        raise ValueError(f"deform_kernel: bias {tuple(bias.shape)} != {(C_out,)}")
    if max(x.numel(), offsets.numel(), B * Ho * W * C_out) >= 2**31:
        raise ValueError(f"deform_kernel indexes in int32; {tuple(offsets.shape)} is too large")
    x, offsets, masks = x.contiguous(), offsets.contiguous(), masks.contiguous()
    lanes = C // lane_width(Cg, x.data_ptr())
    if lanes > 512 and Cg % 4 == 0:
        # Only a misaligned x gets here (a view into a larger buffer): a
        # fresh copy is aligned and takes the float4 lanes.
        x = x.clone()
        lanes = C // lane_width(Cg, x.data_ptr())
    if lanes > 512:
        raise ValueError(f"deform_kernel takes at most 512 lanes (C/4, or C where "
                         f"C/G % 4 != 0) a pixel; C={C}, groups={G}")
    # (C_out, Cg, K, K) -> (T, Cg, C_out): per tap and group channel, the
    # outputs of every group side by side
    w_t = weight.reshape(C_out, Cg, K * K).permute(2, 1, 0).contiguous()
    bias = bias.contiguous()
    out = torch.empty((B, Ho, W, C_out), dtype=torch.float32, device=x.device)
    if out.numel() == 0:  # nothing to launch
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _get_lib().tpuvc_deform_conv_nhwc(
            x.data_ptr(), offsets.data_ptr(), masks.data_ptr(), w_t.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, H, W, G, Cg, Og, K, y0, Ho, stream,
        )
    if rc != 0:
        raise RuntimeError(f"deform kernel launch failed: cudaError {rc}")
    deform_kernel.launches += 1
    if outputs_per_lane(Cg, Og, x.data_ptr()) > 2:
        deform_kernel.wide_launches += 1
    return out


#: Kernel launches since the count was last set to 0, and those of them
#: that took the kernel's ``<V, MAXO>`` instance (:func:`outputs_per_lane`).
deform_kernel.launches = 0
deform_kernel.wide_launches = 0


class _DeformKernelFn(torch.autograd.Function):
    """Kernel forward; backward by autograd of the plain formulation."""

    @staticmethod
    def forward(ctx, x, offsets, masks, weight, bias, groups, kernel, y0):
        ctx.save_for_backward(x, offsets, masks, weight, bias)
        ctx.args = (groups, kernel, y0)
        return deform_kernel(x, offsets, masks, weight, bias, groups, kernel, y0)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            out = deform_plain(*inputs, *ctx.args)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if n else None for n in needs), None, None, None)


def deform_conv2d(x, offsets, masks, weight, bias, groups: int,
                  kernel: int = 3, y0: int = 0) -> torch.Tensor:
    """Modulated deformable conv (arguments as :func:`deform_plain`).

    CPU tensors take :func:`deform_plain`; CUDA tensors the kernel.
    """
    if x.device.type == "cpu":
        return deform_plain(x, offsets, masks, weight, bias, groups, kernel, y0)
    if masks is None:
        masks = torch.ones((*offsets.shape[:3], groups * kernel * kernel),
                           dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros((weight.shape[0],), dtype=x.dtype, device=x.device)
    args = (x, offsets, masks, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _DeformKernelFn.apply(*args, groups, kernel, y0)
    return deform_kernel(*args, groups, kernel, y0)


class DeformConv(nn.Module):
    """Learnable weight (C_out, C_in // groups, K, K) and bias; offsets and
    masks come from the caller."""

    def __init__(self, in_features: int, features: int, groups: int = 8,
                 kernel: int = 3):
        super().__init__()
        self.groups = groups
        self.kernel = kernel
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kernel, kernel)
        )
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        lecun_normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x, offsets, masks=None, y0: int = 0):
        return deform_conv2d(x, offsets, masks, self.weight, self.bias,
                             self.groups, self.kernel, y0)
