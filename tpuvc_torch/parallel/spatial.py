"""Spatial sharding: the rows of NHWC frames split across the ranks of a mesh
(port of tpuvc.parallel.mesh.shard_spatial and of the H-sharded forwards of
every tpuvc family that XLA's partitioner gives tpuvc: LHBDC, Flex-Rate,
FlowGuidedB, DeformB, DMC and ELIC).

tpuvc places frames with H sharded over its 1-D mesh and XLA's SPMD
partitioner inserts a halo exchange for every conv and a collective for
every global op. The port runs one process per device (parallel/mesh.py)
and has no partitioner, so each op that mixes rows fetches the rows it needs
from the ranks that own them, here, explicitly:

- Layout. :func:`rows_of` is the one ownership rule: rank r owns rows
  ``[r*c, min(H, (r+1)*c))`` of a tensor of H rows, ``c = ceil(H/n)``. At
  the entry this is XLA's placement (``shard_spatial`` refuses an H the
  mesh does not divide); at the deep levels of a codec a rank may own
  fewer rows than others, or none. Every sharded tensor is canonical under
  the rule, so every rank knows every rank's rows without a collective. A
  sharded tensor is a :class:`Rows`: this rank's rows and the global H.
- Transport. :func:`fetch_rows` is the one communication primitive: it
  gathers any list of global rows from their owners with paired send/recv
  (ranks in ascending order, one message each way a pair), as far across
  the ranks as the list reaches. :func:`gather_rows` fetches all of them
  (the warps' references); :func:`all_reduce_sum` adds the bits.
- Ops (:class:`Spatial`). Each follows one recipe: work out which input
  rows its canonical output rows need, fetch them, run the port's own op
  on that window, crop: convs (the checkerboard's masked one too), pixel
  shuffle, pools, bilinear resizes, pads and crops.
  Pointwise and per-pixel ops (activations, GDN, gains, the entropy models
  in ``dequantize`` mode, channel concat and chunk) run on the local rows as
  they are; the checkerboard masks and DMC's four part masks take the
  parity of the rank's first row.
- Some ops run whole on every rank (``Spatial.whole``: the input
  gathered, the unsharded call, the rank's rows kept), where the H100 sums
  a window in another order than the frame and a forward's latents flip:
  transposed convs (``Spatial.deconv``); for DMC, whose four parts turn
  one flipped latent into many, also SPyNet's flow upsampling and its
  blocks at 1/8 of the frame's rows or fewer, the antialiased resizes, the
  flow's resize back and the MV analysis's first conv.
- The warp and the deform conv. Flows and deform offsets reach anywhere,
  so a rank gathers the whole reference (or feature map) and computes only
  its own output rows: ``ops.warp.warp(..., y0)``,
  ``ops.deform.deform_conv2d(..., y0)`` with y0 its first row, the CUDA
  kernels on a card, each row bit for bit that row of the whole frame's.
- Module forwards, in the order of each module's own ``forward``, on the
  module's own parameters: SPyNet, MaskUNet, MeanScaleHyperprior and LHBDC;
  MSFeature, FlowNET, TemporalEnc, the Reconstructors, CondELIC,
  OffsetDiversity, FlowGuidedB and DeformB; UNet, GainedHyperprior and
  Flex-Rate's BidirFlowRef; DMC's four-part coder and one P-frame of
  PFrameDMC (its DPB as rows in and out, so P-frames chain sharded); ELIC
  (:func:`spatial_forward`, each family on its own positional inputs). The
  warps of every family (Flex-Rate's ``flexrate`` ones, DMC's ``exact``
  ones over 3 and 48 channels) run at the rank's rows, each counted in
  :class:`SpatialStats`.

Ranks that share a card use gloo, which moves CUDA tensors through host
copies; NCCL moves them where each rank has its own card. The forward is
inference only (``mode="dequantize"``): no gradient crosses a fetch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpuvc_torch.entropy.emath import clip, likelihood_to_bits, per_sample_bits
from tpuvc_torch.entropy.quant import quantize, ste_round
from tpuvc_torch.models import layers as L
from tpuvc_torch.models.cond_elic import _ChannelContext, _EntropyParams, _Head, _SynthStage
from tpuvc_torch.models.deform_b import DeformB, _head_to_deform
from tpuvc_torch.models.dmc import MV_FEAT, PFrameDMC, down_size, split_params
from tpuvc_torch.models.elic import ELIC
from tpuvc_torch.models.flexrate import BidirFlowRef, blend, project_flow
from tpuvc_torch.models.flowguided_b import FlowGuidedB, convert_scales
from tpuvc_torch.models.lhbdc import LHBDC
from tpuvc_torch.models.ms_feature import _ConvRBB
from tpuvc_torch.models.spynet import preprocess
from tpuvc_torch.models.unet import _avgpool2, _lrelu, _maxpool2
from tpuvc_torch.ops import checkerboard
from tpuvc_torch.ops import warp as warp_ops
from tpuvc_torch.ops.checkerboard import CheckerboardConv
from tpuvc_torch.ops.pad import _pad_index
from tpuvc_torch.ops.resample import (
    _resize_matrix,
    _resize_matrix_on,
    avg_pool2d,
    bilinear_resize,
    pixel_shuffle,
    resize_antialias,
    upsample2x_flow,
)
from tpuvc_torch.parallel.mesh import Mesh, _staged, _tree_map

# -- layout -------------------------------------------------------------------


def rows_of(H: int, n: int, r: int) -> tuple[int, int]:
    """The rows ``[start, stop)`` rank ``r`` of ``n`` owns of a tensor of
    ``H`` rows: ``[r*c, min(H, (r+1)*c))`` with ``c = ceil(H/n)``; empty
    (``start == stop == H``) where ``r*c >= H``."""
    c = -(-H // n)
    return min(H, r * c), min(H, (r + 1) * c)


@dataclasses.dataclass(frozen=True)
class Rows:
    """This rank's rows ``x`` (B, h, W, C) of an NHWC tensor of ``H`` rows
    (the rows :func:`rows_of` gives it). A dataclass, not a tensor
    subclass: a torch op on a subclass would drop ``H`` without a word."""

    x: torch.Tensor
    H: int

    def map(self, fn, *others: "Rows") -> "Rows":
        """``fn`` of the local rows (and of ``others``' rows of the same H):
        for ops that do not mix rows."""
        for o in others:
            if o.H != self.H:
                raise ValueError(f"rows of H={o.H} meet rows of H={self.H}")
        return Rows(fn(self.x, *(o.x for o in others)), self.H)


def cat(parts: list[Rows], dim: int) -> Rows:
    """torch.cat of the local rows along the batch (0) or channel (-1) dim."""
    if dim not in (0, -1, 3):
        raise ValueError("rows are concatenated along the batch or channel dim only")
    return parts[0].map(lambda *xs: torch.cat(xs, dim=dim), *parts[1:])


def take_rows(mesh: Mesh, x: torch.Tensor) -> Rows:
    """This rank's rows of the whole NHWC tensor ``x`` under
    :func:`rows_of`, at any H."""
    if x.dim() != 4:
        raise ValueError(f"rows are taken of NHWC tensors, got {tuple(x.shape)}")
    lo, hi = rows_of(x.shape[1], mesh.size, mesh.rank)
    return Rows(x[:, lo:hi].contiguous(), x.shape[1])


def shard_spatial(mesh: Mesh, tree):
    """This rank's rows of each NHWC tensor in ``tree``, as :class:`Rows`
    (tpuvc's ``shard_spatial``: H sharded over the mesh). Raises where the
    mesh size does not divide H, as JAX's placement does."""
    def take(x):
        if x.dim() == 4 and x.shape[1] % mesh.size:
            raise ValueError(f"the H dimension of {tuple(x.shape)} should be divisible by "
                             f"{mesh.size}, but it is equal to {x.shape[1]}")
        return take_rows(mesh, x)

    return _tree_map(take, tree)


# -- transport ------------------------------------------------------------------


@dataclasses.dataclass
class SpatialStats:
    """What one rank's sharded ops moved, warped and deformed: the bytes it
    received from other ranks over its exchanges with them (``fetches``),
    each warp and each deform conv as (y0, rows, input rows, batch, input
    channels), the warp samples whose row lies in another rank's rows out
    of all its samples, and the deform taps whose sample row (the upper of
    its two) lies in another rank's rows out of all its taps."""

    bytes_fetched: int = 0
    fetches: int = 0
    warps: list = dataclasses.field(default_factory=list)
    samples: int = 0
    samples_elsewhere: int = 0
    deforms: list = dataclasses.field(default_factory=list)
    taps: int = 0
    taps_elsewhere: int = 0


def _owner(rows: np.ndarray, H: int, n: int) -> np.ndarray:
    return rows // -(-H // n)


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as it travels: through host memory and as float32 on gloo
    (which has no 16-bit floats; the widening is exact)."""
    if mesh.backend == "gloo":
        t = t.cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
    return t.contiguous()


def _wire_buffer(mesh: Mesh, x: torch.Tensor, rows: int) -> torch.Tensor:
    """A buffer for ``rows`` rows of ``x`` as they travel (:func:`_wire`)."""
    shape = (x.shape[0], rows, *x.shape[2:])
    if mesh.backend != "gloo":
        return x.new_empty(shape)
    wide = x.dtype in (torch.bfloat16, torch.float16)
    return torch.empty(shape, dtype=torch.float32 if wide else x.dtype)


def fetch_rows(mesh: Mesh, shard: Rows, need, stats: SpatialStats | None = None,
               tag: int = 0) -> torch.Tensor:
    """The global rows ``need(mesh.rank)`` of ``shard``, in that order, as a
    (B, len, W, C) tensor on this rank.

    ``need(r)`` lists the rows rank ``r`` asks for (any order, repeats
    allowed, each in ``[0, H)``), a pure function of ``r`` that every rank
    evaluates alike, so each knows what to send to whom without a
    collective. Each rank then sends every peer, in ascending rank order,
    one message of the rows it owns of that peer's list, and receives one
    from each peer it needs rows from (``tag`` names the exchange). A list
    of consecutive rows of this rank's own comes back as a view of its
    shard, in the shard's memory layout (so a one-rank forward runs the
    unsharded one's kernels)."""
    H, n, me = shard.H, mesh.size, mesh.rank
    lo, _ = rows_of(H, n, me)
    x = shard.x
    mine = np.asarray(need(me), dtype=np.int64).reshape(-1)
    if mine.size and (mine.min() < 0 or mine.max() >= H):
        raise ValueError(f"rows outside [0, {H}) asked for")
    owners = _owner(mine, H, n)

    def index(a):
        return torch.as_tensor(a, dtype=torch.long, device=x.device)

    here = np.nonzero(owners == me)[0]
    if mine.size and here.size == mine.size and bool(np.all(np.diff(mine) == 1)):
        out = x.narrow(1, int(mine[0]) - lo, mine.size)
    else:
        out = x.new_empty((x.shape[0], mine.size, *x.shape[2:]))
        if here.size:
            out.index_copy_(1, index(here), x.index_select(1, index(mine[here] - lo)))
    if n == 1 or mesh.group is None:
        return out
    ops, recvs = [], []
    for peer in range(n):
        if peer == me:
            continue
        theirs = np.asarray(need(peer), dtype=np.int64).reshape(-1)
        send = theirs[_owner(theirs, H, n) == me]
        if send.size:
            t = _wire(mesh, x.index_select(1, index(send - lo)))
            ops.append(dist.P2POp(dist.isend, t, peer, group=mesh.group, tag=tag))
        get = np.nonzero(owners == peer)[0]
        if get.size:
            buf = _wire_buffer(mesh, x, get.size)
            ops.append(dist.P2POp(dist.irecv, buf, peer, group=mesh.group, tag=tag))
            recvs.append((get, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for get, buf in recvs:
        out.index_copy_(1, index(get), buf.to(x.device, x.dtype))
        if stats is not None:
            stats.bytes_fetched += buf.numel() * buf.element_size()
    if stats is not None:
        stats.fetches += 1
    return out


def gather_rows(mesh: Mesh, shard: Rows, stats: SpatialStats | None = None) -> torch.Tensor:
    """The whole (B, H, W, C) tensor on every rank."""
    return fetch_rows(mesh, shard, lambda r: np.arange(shard.H), stats)


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks."""
    if mesh.group is None:
        return x

    def reduce(ts):
        dist.all_reduce(ts[0], op=dist.ReduceOp.SUM, group=mesh.group)
        return ts

    return _staged(mesh, reduce, [x.clone()])[0]


# -- sharded ops ------------------------------------------------------------------


def _span(a: int, b: int, lo: int, hi: int, H: int) -> np.ndarray:
    """Rows ``[lo, hi)`` clipped to ``[0, H)``; none for an empty output
    ``[a, b)``."""
    if a >= b:
        return np.zeros(0, dtype=np.int64)
    return np.arange(max(lo, 0), min(hi, H))


class Spatial:
    """The sharded ops of this rank over ``mesh``; ``stats`` (a
    :class:`SpatialStats`) adds up what they fetch, warp and deform."""

    def __init__(self, mesh: Mesh, stats: SpatialStats | None = None):
        self.mesh, self.stats = mesh, stats
        self._tag = 0

    def rows(self, H: int, r: int | None = None) -> tuple[int, int]:
        return rows_of(H, self.mesh.size, self.mesh.rank if r is None else r)

    def fetch(self, x: Rows, need) -> torch.Tensor:
        self._tag = (self._tag + 1) % 2**15
        return fetch_rows(self.mesh, x, need, self.stats, self._tag)

    def _windowed(self, x: Rows, H_out: int, span, op) -> Rows:
        """The recipe: output rows ``[a, b)`` of ``H_out`` need input rows
        ``span(a, b)``; ``op(window, a, b)`` computes them."""
        def need(r):
            return span(*self.rows(H_out, r))

        a, b = self.rows(H_out)
        return Rows(op(self.fetch(x, need), a, b), H_out)

    # convolutions -------------------------------------------------------------

    def conv(self, x: Rows, conv) -> Rows:
        """``layers.Conv`` (``conv2d_nhwc``, pad k//2) or
        ``CheckerboardConv`` (its masked kernel, float32 whatever the
        policy, as its forward) on its own parameters: output rows
        ``[a, b)`` read input rows ``[a*s - p, (b-1)*s - p + k)``, zeros
        outside the frame."""
        if isinstance(conv, CheckerboardConv):
            weight, bias, stride = conv.weight * conv.mask, conv.bias, 1

            def fn(win, pad):
                y = F.conv2d(win.permute(0, 3, 1, 2), weight, padding=pad)
                return y.permute(0, 2, 3, 1) + bias
        else:
            weight, bias, stride = conv.weight, conv.bias, conv.stride

            def fn(win, pad):
                return L.conv2d_nhwc(win, weight, bias, stride, pad)

        k = weight.shape[-1]
        p = k // 2
        H, W = x.H, x.x.shape[2]
        H_out = (H + 2 * p - k) // stride + 1
        W_out = (W + 2 * p - k) // stride + 1

        def span(a, b):
            return _span(a, b, a * stride - p, (b - 1) * stride - p + k, H)

        def op(win, a, b):
            if a >= b:
                return win.new_zeros((win.shape[0], 0, W_out, weight.shape[0]),
                                     dtype=torch.float32)
            if (a, b) == (0, H_out):  # the whole frame: the unsharded call
                return fn(win, p)
            top = a * stride - p
            bottom = (b - 1) * stride - p + k
            return fn(F.pad(win, (0, 0, 0, 0, max(0, -top), max(0, bottom - H))), (0, p))

        return self._windowed(x, H_out, span, op)

    def whole(self, x: Rows, fn) -> Rows:
        """``fn`` (any op along H) of the whole input on every rank, which
        keeps its own rows of the output: the unsharded forward's own call,
        for ops whose windows the H100 sums otherwise than the whole frame
        (cuDNN's convs, cuBLAS's matmuls)."""
        y = fn(self.fetch(x, lambda r: np.arange(x.H)))
        a, b = self.rows(y.shape[1])
        return Rows(y[:, a:b], y.shape[1])

    def deconv(self, x: Rows, deconv: L.Deconv) -> Rows:
        """``layers.Deconv`` (a stride-s transposed conv), :meth:`whole`.
        Output rows ``[a, b)`` need only input rows ``[ceil((a + p - k +
        1)/s), floor((b - 1 + p)/s)]`` (p = k//2), but cuDNN sums a window's
        transposed conv in another order than the whole frame's at every
        shape of the v3/v4 codecs on the H100, and in their forwards those
        sums flip quantized latents (PERF.md §6)."""
        return self.whole(x, deconv)

    def pixel_shuffle(self, x: Rows, r: int) -> Rows:
        """Output row y is input row y // r."""
        def op(win, a, b):
            return pixel_shuffle(win, r)[:, a - (a // r) * r:][:, :b - a]

        return self._windowed(x, x.H * r, lambda a, b: _span(a, b, a // r, (b - 1) // r + 1, x.H),
                              op)

    def pool(self, x: Rows, k: int, fn=None) -> Rows:
        """Non-overlapping k x k pooling (``avg_pool2d``, or ``fn``):
        output rows ``[a, b)`` read input rows ``[a*k, b*k)``."""
        if x.H % k:
            raise ValueError(f"H={x.H} does not divide by the pool {k}")
        fn = fn or (lambda t: avg_pool2d(t, k))
        return self._windowed(x, x.H // k, lambda a, b: _span(a, b, a * k, b * k, x.H),
                              lambda win, a, b: fn(win))

    def max_pool2(self, x: Rows) -> Rows:
        return self.pool(x, 2, _maxpool2)

    # resampling ------------------------------------------------------------------

    def resize(self, x: Rows, out_h: int, out_w: int, align_corners: bool = False) -> Rows:
        """``resample.bilinear_resize`` for the global H: output rows
        ``[a, b)`` read the nonzero band of the interpolation matrix's rows
        ``[a, b)``, the columns are resized on the local rows."""
        H, W = x.H, x.x.shape[2]
        if H == out_h and W == out_w:
            return x
        m = _resize_matrix(H, out_h, align_corners)

        def span(a, b):
            if a >= b:
                return _span(a, b, 0, 0, H)
            cols = np.nonzero(m[a:b].any(axis=0))[0]
            return np.arange(cols[0], cols[-1] + 1)

        def op(win, a, b):
            if a >= b:
                return win.new_zeros((win.shape[0], 0, out_w, win.shape[3]))
            c0 = int(np.nonzero(m[a:b].any(axis=0))[0][0])
            mh = _resize_matrix_on(H, out_h, align_corners, win.device, win.dtype)
            mw = _resize_matrix_on(W, out_w, align_corners, win.device, win.dtype)
            y = torch.einsum("oh,...hwc->...owc", mh[a:b, c0:c0 + win.shape[1]], win)
            return torch.einsum("pw,...hwc->...hpc", mw, y)

        return self._windowed(x, out_h, span, op)

    def resize_antialias(self, x: Rows, out_h: int, out_w: int) -> Rows:
        """``resample.resize_antialias`` (DMC's downsampled frames),
        :meth:`whole`. A window of output rows needs only the band of about
        2·H/out_h input rows a row of the antialias matrix reaches, but the
        band's matmuls sum otherwise than the whole frame's on the H100, and
        DMC's four parts turn the flips that follow into many (PERF.md
        §6); a 3-channel frame costs little to gather."""
        return self.whole(x, lambda t: resize_antialias(t, out_h, out_w))

    def upsample2x_flow(self, flow: Rows) -> Rows:
        """``resample.upsample2x_flow`` (SPyNet's pyramid step),
        :meth:`whole`: a window's matmuls sum otherwise than the whole
        level's on the H100 at the pyramid's shapes, which flips DMC's
        latents (PERF.md §6); a 2-channel flow costs little to gather."""
        return self.whole(flow, upsample2x_flow)

    def upsample_flow(self, flow: Rows, factor: int) -> Rows:
        """``resample.upsample_flow``."""
        return self.resize(flow, factor * flow.H, factor * flow.x.shape[2])

    def up2(self, x: Rows) -> Rows:
        """``unet._up2``."""
        return self.resize(x, 2 * x.H, 2 * x.x.shape[2])

    # padding ------------------------------------------------------------------

    def pad_to_multiple(self, x: Rows, multiple: int = 64, mode: str = "reflect"):
        """``pad.pad_to_multiple``. ``reflect`` or ``edge``: output row i
        of H + ph is input row ``_pad_index(H, ph)[i]``, which a reflected
        pad takes from deep inside the frame, from other ranks' rows.
        ``constant``: output rows ``[a, b)`` are input rows
        ``[a, min(b, H))`` and zeros below. Returns (padded rows, (H, W))."""
        h, w = x.H, x.x.shape[2]
        ph = (multiple - h % multiple) % multiple
        pw = (multiple - w % multiple) % multiple
        if ph and mode == "constant":
            x = self._windowed(x, h + ph, lambda a, b: _span(a, b, a, b, h),
                               lambda win, a, b: F.pad(win, (0, 0, 0, 0, 0,
                                                             max(0, b - max(a, h)))))
        elif ph:
            idx = _pad_index(h, ph, mode, "cpu").numpy()
            x = self._windowed(x, h + ph, lambda a, b: idx[a:b], lambda win, a, b: win)
        if pw and mode == "constant":
            x = x.map(lambda t: F.pad(t, (0, 0, 0, pw)))
        elif pw:
            x = x.map(lambda t: t.index_select(-2, _pad_index(w, pw, mode, t.device)))
        return x, (h, w)

    def unpad(self, x: Rows, size: tuple[int, int]) -> Rows:
        """``pad.unpad``: rows ``[0, h)`` re-sharded over h, columns cut."""
        h, w = size
        if h != x.H:
            x = self._windowed(x, h, lambda a, b: np.arange(a, b), lambda win, a, b: win)
        return x.map(lambda t: t[:, :, :w])

    # the warp ------------------------------------------------------------------

    def warp(self, img: Rows, flow: Rows, compat: str = "exact") -> Rows:
        """``ops.warp.warp`` of this rank's output rows: the whole reference
        gathered, the flow's own rows, ``y0`` the first of them. On CUDA
        tensors the kernel launches (or raises); a rank without rows
        launches nothing."""
        if img.H != flow.H:
            raise ValueError(f"a reference of H={img.H} warped by a flow of H={flow.H}")
        ref = gather_rows(self.mesh, img, self.stats)
        y0, y1 = self.rows(img.H)
        if y0 == y1:
            return Rows(ref[:, :0], img.H)
        if self.stats is not None:
            self._count_samples(flow.x, y0, y1, ref.shape, compat)
        return Rows(warp_ops.warp(ref, flow.x, compat, y0), img.H)

    def _count_samples(self, flow, y0: int, y1: int, ref_shape, compat: str) -> None:
        """Add the warp of rows [y0, y1) to the stats, and how many of its
        sample points' rows lie outside them."""
        B, H, W, C = ref_shape
        _, sy, zero = warp_ops._scales(compat, H, W)
        dy = flow[..., 1] - 0.5 if zero else flow[..., 1]
        rows = torch.arange(y0, y1, dtype=flow.dtype, device=flow.device)[None, :, None]
        y = torch.floor(torch.clamp(rows + dy * sy, 0.0, H - 1.0))
        s = self.stats
        s.warps.append((y0, y1 - y0, H, B, C))
        s.samples += y.numel()
        s.samples_elsewhere += int(((y < y0) | (y >= y1)).sum())

    # the deform conv ----------------------------------------------------------

    def deform(self, x: Rows, offsets: Rows, masks: Rows, conv) -> Rows:
        """``conv`` (an ``ops.deform.DeformConv``) of this rank's output
        rows: x gathered whole (offsets centred on a flow reach anywhere,
        as flows do), the offsets' and masks' own rows, ``y0`` the first of
        them. On CUDA tensors the kernel launches (or raises); a rank
        without rows launches nothing."""
        if not x.H == offsets.H == masks.H:
            raise ValueError(f"a deform of H={x.H} by offsets of H={offsets.H}, "
                             f"masks of H={masks.H}")
        full = gather_rows(self.mesh, x, self.stats)
        y0, y1 = self.rows(x.H)
        if y0 == y1:
            return Rows(full.new_zeros((full.shape[0], 0, full.shape[2], conv.weight.shape[0])),
                        x.H)
        if self.stats is not None:
            self._count_taps(offsets.x, y0, y1, full.shape, conv.kernel)
        return Rows(conv(full, offsets.x, masks.x, y0=y0), x.H)

    def _count_taps(self, offsets, y0: int, y1: int, x_shape, K: int) -> None:
        """Add the deform of rows [y0, y1) to the stats, and how many of its
        taps sample (at their upper row) a row of the frame outside them."""
        B, H, W, C = x_shape
        dy = offsets[..., 0::2].reshape(*offsets.shape[:3], -1, K * K)
        base = torch.arange(K * K, device=offsets.device) // K - K // 2
        rows = torch.arange(y0, y1, device=offsets.device)[None, :, None, None, None]
        y = torch.floor(rows + base + dy)
        s = self.stats
        s.deforms.append((y0, y1 - y0, H, B, C))
        s.taps += y.numel()
        s.taps_elsewhere += int((((y < y0) | (y >= y1)) & (y >= 0) & (y < H)).sum())

    # checkerboard masks ------------------------------------------------------

    def keep_anchor(self, x: Rows) -> Rows:
        """``checkerboard.keep_anchor`` of the rank's rows, at the parity of
        their first row."""
        y0 = self.rows(x.H)[0]
        return x.map(lambda t: checkerboard.keep_anchor(t, y0))

    def keep_non_anchor(self, x: Rows) -> Rows:
        """``checkerboard.keep_non_anchor`` likewise."""
        y0 = self.rows(x.H)[0]
        return x.map(lambda t: checkerboard.keep_non_anchor(t, y0))

    # bits ------------------------------------------------------------------

    def bits(self, liks: list[torch.Tensor]) -> tuple[list, list]:
        """(``likelihood_to_bits`` of each likelihood tensor, its
        ``per_sample_bits``) over all ranks: the sums of each rank's own
        rows, then one all-reduce."""
        local = torch.cat([torch.stack([likelihood_to_bits(p) for p in liks])]
                          + [per_sample_bits(p) for p in liks])
        total = all_reduce_sum(self.mesh, local)
        n = len(liks)
        b = liks[0].shape[0]
        return list(total[:n]), [total[n + i * b:n + (i + 1) * b] for i in range(n)]


# -- module forwards ------------------------------------------------------------------


def _per_pixel(fn, *rows: Rows) -> tuple:
    """``fn`` of the rows' tensors (the entropy models, the offset heads'
    preparation: per pixel), each of its outputs as :class:`Rows`."""
    return tuple(Rows(t, rows[0].H) for t in fn(*(r.x for r in rows)))


def _run(sp: Spatial, layers, x: Rows, act=None) -> Rows:
    """``layers`` in turn, ``act`` after each but the last."""
    layers = list(layers)
    for i, lay in enumerate(layers):
        x = layer(sp, lay, x)
        if act is not None and i < len(layers) - 1:
            x = x.map(act)
    return x


def _chain(sp: Spatial, module, x: Rows, names, act=None) -> Rows:
    """``module``'s submodules ``names`` in turn, ``act`` after each but
    the last."""
    return _run(sp, (getattr(module, name) for name in names), x, act)


def _blocks(n: int) -> list:
    return [f"ResidualBottleneckBlock_{i}" for i in range(n)]


def layer(sp: Spatial, module, x: Rows) -> Rows:
    """One of the codec transforms' layers (models/layers.py and the v3/v4
    stages built of them), its ``forward`` with the row-mixing ops
    sharded."""
    if isinstance(module, (L.Conv, CheckerboardConv)):
        return sp.conv(x, module)
    if isinstance(module, L.Deconv):
        return sp.deconv(x, module)
    if isinstance(module, L.ResidualBottleneckBlock):
        return _chain(sp, module, x, ("Conv_0", "Conv_1", "Conv_2"), F.relu).map(torch.add, x)
    if isinstance(module, _ConvRBB):
        return _chain(sp, module, x, ["Conv_0"] + _blocks(module.blocks))
    if isinstance(module, _SynthStage):
        return _chain(sp, module, x, ["Conv_0"] + _blocks(3) + ["Deconv_0"])
    if isinstance(module, _Head):
        return _chain(sp, module, x, ["Conv_0"] + _blocks(3) + ["Conv_1"])
    if isinstance(module, _EntropyParams):
        return _chain(sp, module, x, ("Conv_0", "Conv_1", "Conv_2"), L.leaky_relu)
    if isinstance(module, _ChannelContext):
        return _chain(sp, module, x, ("Conv_0", "Conv_1", "Conv_2"), F.relu)
    if isinstance(module, L.SubpelConv):
        return sp.pixel_shuffle(sp.conv(x, module.Conv_0), module.r)
    if isinstance(module, L.GDN):
        return x.map(module)
    if isinstance(module, L.ResidualBlock):
        out = layer(sp, module.Conv_0, x).map(L.leaky_relu)
        out = layer(sp, module.Conv_1, out).map(L.leaky_relu)
        identity = layer(sp, module.Conv_2, x) if hasattr(module, "Conv_2") else x
        return out.map(torch.add, identity)
    if isinstance(module, L.ResidualBlockWithStride):
        out = layer(sp, module.Conv_0, x).map(L.leaky_relu)
        out = layer(sp, module.GDN_0, layer(sp, module.Conv_1, out))
        skip = layer(sp, module.Conv_2, x) if hasattr(module, "Conv_2") else x
        return out.map(torch.add, skip)
    if isinstance(module, L.ResidualBlockUpsample):
        out = layer(sp, module.SubpelConv_0, x).map(L.leaky_relu)
        out = layer(sp, module.GDN_0, layer(sp, module.Conv_0, out))
        return out.map(torch.add, layer(sp, module.SubpelConv_1, x))
    if isinstance(module, L.ResidualUnit):
        out = _chain(sp, module, x, ("Conv_0", "Conv_1", "Conv_2"), F.relu)
        return out.map(lambda t, i: F.relu(t + i), x)
    if isinstance(module, L.AttentionBlock):
        a = _chain(sp, module, x, [f"ResidualUnit_{i}" for i in range(3)])
        b = _chain(sp, module, x, [f"ResidualUnit_{i}" for i in range(3, 6)])
        gate = layer(sp, module.Conv_0, b)
        return x.map(lambda t, a, g: t + a * torch.sigmoid(g), a, gate)
    raise TypeError(f"no sharded forward for {type(module).__name__}")


def hyperprior_forward(sp: Spatial, m, x: Rows, mode: str = "dequantize",
                       rate: tuple | None = None) -> dict:
    """``MeanScaleHyperprior.forward``: g_a, h_a, the bottleneck, h_s, the
    Gaussian conditional and g_s, the entropy models on the local rows.
    With ``rate`` (a level n and an interpolation l) ``GainedHyperprior.
    forward``: its four per-channel gain units, on the local rows, after
    g_a and h_a and before h_s and g_s."""
    def gain(unit, t: Rows) -> Rows:
        return t if rate is None else t.map(lambda v: getattr(m, unit)(v, *rate))

    y = gain("gain_unit", _run(sp, m.g_a_layers, x))
    z = gain("hyper_gain_unit", _run(sp, m.h_a_convs, y, L.leaky_relu))
    z_hat, z_lik = _per_pixel(lambda t: m.entropy_bottleneck(t, mode), z)
    h = layer(sp, m.h_s_conv0, gain("hyper_inv_gain_unit", z_hat)).map(L.leaky_relu)
    h = layer(sp, m.h_s_up0, h).map(L.leaky_relu)
    h = layer(sp, m.h_s_conv1, h).map(L.leaky_relu)
    h = layer(sp, m.h_s_up1, h).map(L.leaky_relu)

    def gaussian(t, params):
        scales, means = torch.chunk(params, 2, dim=-1)
        return m.gaussian(t, scales, means=means, mode=mode)

    y_hat, y_lik = _per_pixel(gaussian, y, layer(sp, m.h_s_out, h))
    out = _run(sp, m.g_s_layers, gain("inv_gain_unit", y_hat))
    return {"x_hat": out, "likelihoods": {"y": y_lik.x, "z": z_lik.x}}


def basic_block_forward(sp: Spatial, block, x: Rows) -> Rows:
    """SPyNet's ``BasicBlock.forward``: five 7x7 convs, ReLU between."""
    n = len(block.FEATS)
    for i in range(n):
        x = layer(sp, getattr(block, f"conv{i}"), x)
        if i < n - 1:
            x = x.map(F.relu)
    return x


def spynet_forward(sp: Spatial, net, first: Rows, second: Rows) -> Rows:
    """``SPyNet.forward``: the pyramid's depth and the zero initial flow
    follow the global shape; each level warps the gathered ``second``. The
    blocks of the levels at 1/8 of the frame's rows or fewer run
    :meth:`Spatial.whole`: cuDNN sums their 7x7 convs' windows otherwise
    than the whole level's on the H100, and DMC's four parts turn a flipped
    latent into many (PERF.md §6); those levels cost little."""
    firsts, seconds = [first.map(preprocess)], [second.map(preprocess)]
    for _ in range(5):
        if firsts[0].H > 32 or firsts[0].x.shape[2] > 32:
            firsts.insert(0, sp.pool(firsts[0], 2))
            seconds.insert(0, sp.pool(seconds[0], 2))
    b, h0, w0 = first.x.shape[0], firsts[0].H, firsts[0].x.shape[2]
    lo, hi = sp.rows(h0 // 2)
    flow = Rows(torch.zeros((b, hi - lo, w0 // 2, 2), dtype=first.x.dtype,
                            device=first.x.device), h0 // 2)
    for level in range(len(firsts)):
        up = sp.upsample2x_flow(flow)
        if (up.H, up.x.shape[2]) != (firsts[level].H, firsts[level].x.shape[2]):
            raise ValueError(f"pyramid level {level}: flow {up.H} rows, frame {firsts[level].H}")
        warped = sp.warp(seconds[level], up, net.warp_compat)
        inp = cat([firsts[level], warped, up], dim=-1)
        block = getattr(net, f"basic_{min(level, net.num_levels - 1)}")
        if 8 * inp.H <= first.H:
            flow = sp.whole(inp, block)
        else:
            flow = basic_block_forward(sp, block, inp)
        flow = flow.map(torch.add, up)
    return flow


def mask_unet_forward(sp: Spatial, net, x: Rows) -> Rows:
    """``MaskUNet.forward``."""
    def conv_relu(name, t):
        return layer(sp, getattr(net, name), t).map(F.relu)

    c1 = conv_relu("Conv_0", x)
    c2 = conv_relu("Conv_1", sp.max_pool2(c1))
    c3 = conv_relu("Conv_2", sp.max_pool2(c2))
    t = conv_relu("Conv_3", sp.max_pool2(c3))
    t = conv_relu("Conv_4", cat([sp.up2(t), c3], dim=-1))
    t = conv_relu("Conv_5", cat([sp.up2(t), c2], dim=-1))
    t = conv_relu("Conv_6", cat([sp.up2(t), c1], dim=-1))
    return layer(sp, net.Conv_7, t).map(torch.sigmoid)


def unet_forward(sp: Spatial, net, x: Rows) -> Rows:
    """``UNet.forward`` (Flex-Rate's flow predictor and blend mask): two
    3x3 convs a level, leaky-ReLU 0.1, avg-pool down, then up with skips."""
    convs = iter(getattr(net, f"Conv_{i}") for i in range(net.n_convs))

    def conv_act(t):
        return layer(sp, next(convs), t).map(_lrelu)

    skips = []
    for i in range(net.depth):
        x = conv_act(conv_act(x))
        if i < net.depth - 1:
            skips.append(x)
            x = sp.pool(x, 2, _avgpool2)
    x = conv_act(x)
    for i in reversed(range(net.depth - 1)):
        x = cat([layer(sp, next(convs), sp.up2(x)), skips[i]], dim=-1)
        x = conv_act(conv_act(x))
    return layer(sp, next(convs), x)


def _split(x: Rows, n: int) -> list[Rows]:
    b = x.x.shape[0] // n
    return [Rows(x.x[i * b:(i + 1) * b], x.H) for i in range(n)]


def lhbdc_forward(sp: Spatial, model, x_before: Rows, x_current: Rows, x_after: Rows) -> dict:
    """``LHBDC.forward(x_before, x_current, x_after, "dequantize")``."""
    B, H, W = x_current.x.shape[0], x_current.H, x_current.x.shape[2]
    num_pixels = B * H * W

    fs = _split(spynet_forward(sp, model.flownet,
                               cat([x_before, x_after, x_current, x_current], dim=0),
                               cat([x_after, x_before, x_before, x_after], dim=0)), 4)
    flows, size = [], None
    for f, halve in zip(fs, (True, True, False, False)):
        g = sp.pool(f.map(lambda t: t / 2.0) if halve else f, 4)
        size = size or (g.H, g.x.shape[2])
        flows.append(sp.pad_to_multiple(g, 64)[0])
    flow_ba, flow_ab, flow_cb, flow_ca = flows

    diff_flow = flow_cb.map(torch.sub, flow_ab).map(
        lambda a, b: torch.cat([a, b], dim=-1), flow_ca.map(torch.sub, flow_ba))
    flow_out = hyperprior_forward(sp, model.mv_compressor, diff_flow)
    hat = flow_out["x_hat"]
    flow_cb_hat = hat.map(lambda t, a: torch.chunk(t, 2, dim=-1)[0] + a, flow_ab)
    flow_ca_hat = hat.map(lambda t, a: torch.chunk(t, 2, dim=-1)[1] + a, flow_ba)

    # LHBDC.motion_compensate
    flow_cb_hat = sp.upsample_flow(sp.unpad(flow_cb_hat, size), 4)
    flow_ca_hat = sp.upsample_flow(sp.unpad(flow_ca_hat, size), 4)
    fw = sp.warp(x_before, flow_cb_hat, "lhbdc")
    bw = sp.warp(x_after, flow_ca_hat, "lhbdc")
    mask = mask_unet_forward(sp, model.masknet, cat([fw, bw], dim=-1))
    x_pred = mask.map(lambda m, a, b: m * a + (1.0 - m) * b, fw, bw)

    residual = x_current.map(torch.sub, x_pred)
    res_out = hyperprior_forward(sp, model.residual_compressor, residual)
    x_hat = x_pred.map(torch.add, res_out["x_hat"])

    liks = list(flow_out["likelihoods"].values()) + list(res_out["likelihoods"].values())
    bits, per_sample = sp.bits(liks)
    n_flow = len(flow_out["likelihoods"])
    bits_flow = sum(bits[:n_flow])
    bits_res = sum(bits[n_flow:])
    return {
        "x_hat": x_hat,
        "x_pred": x_pred,
        "rate": (bits_flow + bits_res) / (2.0 * num_pixels),
        "bits": bits_flow + bits_res,
        "bits_flow": bits_flow,
        "bits_residual": bits_res,
        "sizes": sum(per_sample),
    }


def flexrate_forward(sp: Spatial, m, x_before: Rows, x_current: Rows, x_after: Rows, n,
                     l=1.0) -> dict:
    """``BidirFlowRef.forward(x_before, x_current, x_after, n, l,
    "dequantize")``: ``process`` (the UNet's flow projected to t = 0.5, both
    references warped), the gained flow codec, ``compensate`` (four
    ``flexrate`` warps in all, the mask UNet's blend), the gained residual
    codec."""
    x = cat([x_before, x_after], dim=-1)
    mv_before, mv_after = _per_pixel(project_flow, unet_forward(sp, m.flow_predictor, x))
    xt1 = sp.warp(x_before, mv_before, "flexrate")
    xt2 = sp.warp(x_after, mv_after, "flexrate")
    context = cat([mv_before, mv_after, x, xt1, xt2], dim=-1)
    flow_out = hyperprior_forward(sp, m.flow_compressor, cat([context, x_current], dim=-1),
                                  rate=(n, l))
    hat = flow_out["x_hat"]
    mv_before = mv_before.map(lambda t, f: t + f[..., :2], hat)
    mv_after = mv_after.map(lambda t, f: t + f[..., 2:4], hat)
    x_b = sp.warp(x_before, mv_before, "flexrate")
    x_a = sp.warp(x_after, mv_after, "flexrate")
    ctx = cat([mv_before, mv_after, x_before, x_after, x_b, x_a], dim=-1)
    x_comp = unet_forward(sp, m.mask, ctx).map(blend, x_b, x_a)
    res_out = hyperprior_forward(sp, m.residual_compressor, x_current.map(torch.sub, x_comp),
                                 rate=(n, l))
    liks = list(flow_out["likelihoods"].values()) + list(res_out["likelihoods"].values())
    bits, per_sample = sp.bits(liks)
    size = sum(per_sample)
    return {"x_hat": x_comp.map(torch.add, res_out["x_hat"]), "x_comp": x_comp,
            "bits": sum(bits), "size": size, "sizes": size,
            "rate": size / (x_current.H * x_current.x.shape[2])}


def ms_feature_forward(sp: Spatial, m, x: Rows) -> tuple:
    """``MSFeature.forward``: the /2, /4, /8 pyramid."""
    l1 = layer(sp, m._ConvRBB_0, x)
    l2 = layer(sp, m._ConvRBB_1, l1)
    return l1, l2, layer(sp, m._ConvRBB_2, l2)


def flownet_forward(sp: Spatial, net, x: Rows) -> Rows:
    """``FlowNET.forward``: four strided stages down, four up with skips."""
    skips = [layer(sp, net._ConvRBB_0, x)]
    for i in (1, 2, 3):
        skips.append(layer(sp, getattr(net, f"_ConvRBB_{i}"), skips[-1]))
    x = skips[3]
    for i, skip in enumerate((skips[2], skips[1], skips[0], None)):
        x = _chain(sp, net, x, _blocks(2 * i + 2)[2 * i:] + [f"SubpelConv_{i}"])
        if skip is not None:
            x = layer(sp, getattr(net, f"Conv_{i}"), cat([x, skip], dim=-1))
    return x


def temporal_enc_forward(sp: Spatial, m, c1: Rows, c2: Rows, c3: Rows) -> Rows:
    """``TemporalEnc.forward``."""
    y = layer(sp, m._ConvRBB_0, c1)
    y = layer(sp, m._ConvRBB_1, cat([y, c2], dim=-1))
    return layer(sp, m._ConvRBB_2, cat([y, c3], dim=-1))


def reconstructor_forward(sp: Spatial, m, x1: Rows, x2: Rows, x3: Rows) -> Rows:
    """``Reconstructor.forward`` (v4's subpel convs) and
    ``ReconstructorDeconv``'s (v3's transposed convs)."""
    def stage(x, i):
        return _chain(sp, m, x, _blocks(3 * i + 3)[3 * i:] + [f"{m.UP}_{i}"])

    l3 = stage(x3, 0)
    l2 = stage(layer(sp, m.Conv_0, cat([x2, l3], dim=-1)), 1)
    return stage(layer(sp, m.Conv_1, cat([x1, l2], dim=-1)), 2)


def _group_params(sp: Spatial, m, i: int, curr_q: Rows, prev: Rows | None, hyper: Rows) -> Rows:
    """Channel group i's entropy parameters (ELIC's and CondELIC's): the
    checkerboard context of its quantized anchors ``curr_q``, the channel
    context of the earlier groups ``prev`` (i > 0), the hyper prior."""
    ctx = sp.keep_non_anchor(layer(sp, m.context_prediction_models[i], sp.keep_anchor(curr_q)))
    parts = [ctx, hyper]
    if i > 0:
        parts.insert(1, layer(sp, m.channel_context_models[i - 1], prev))
    return layer(sp, m.entropy_parameters[i], cat(parts, dim=-1))


def cond_elic_forward(sp: Spatial, m, inputs, conds, temporal: Rows, s,
                      x_pixel: Rows | None = None) -> dict:
    """``CondELIC.forward(inputs, conds, temporal, s, "dequantize",
    x_pixel=x_pixel)``: the analysis, the bottleneck on z, the hyper
    parameters, each group's checkerboard and channel context and its
    Gaussian likelihood, the synthesis. Likelihoods are this rank's rows."""
    gain, hypergain, invhypergain, invgain = m.interpolate_gain(s)
    i1, i2, i3 = inputs
    if m.pixel_stage:
        y = layer(sp, m.g_a1, cat([layer(sp, m.g_a0, x_pixel), i1], dim=-1))
    else:
        y = layer(sp, m.g_a1, i1)
    y = layer(sp, m.g_a2, cat([y, i2], dim=-1))
    y = layer(sp, m.g_a3, cat([y, i3], dim=-1)).map(lambda t: t * gain)
    z = _chain(sp, m, y, ("h_a1", "h_a2", "h_a3"), F.relu).map(lambda t: t * hypergain)
    likelihoods = {"z": _per_pixel(lambda t: m.entropy_bottleneck(t, "dequantize"), z)[1].x}

    h = _chain(sp, m, z.map(lambda t: ste_round(t) * invhypergain), ("h_s1", "h_s2", "h_s3"),
               F.relu)
    hyper = layer(sp, m.prior_fusion_in, cat([h, temporal], dim=-1))
    for blk in m.prior_fusion_blocks:
        hyper = layer(sp, blk, hyper)
    hyper = layer(sp, m.prior_fusion_out, hyper)

    def ctx_quant(v):
        return ste_round(v) if m.ctx_ste else quantize(v, "dequantize")

    def gaussian(t, params):
        scales, means = torch.chunk(params, 2, dim=-1)
        return m.gaussian(t, scales, means=means, mode="dequantize")

    bounds = np.cumsum((0,) + tuple(m.groups))
    for i in range(len(m.groups)):
        curr_y = y.map(lambda t, i=i: t[..., bounds[i]:bounds[i + 1]])
        prev = y.map(lambda t, i=i: ctx_quant(t[..., :bounds[i]])) if i > 0 else None
        params = _group_params(sp, m, i, curr_y.map(ctx_quant), prev, hyper)
        likelihoods[f"y_{i}"] = _per_pixel(gaussian, curr_y, params)[1].x

    x = y.map(lambda t: ste_round(t) * invgain)
    for blk in m.g_s3_blocks:
        x = layer(sp, blk, x)
    inp3 = cat([layer(sp, m.g_s3_up, x), conds[2]], dim=-1)
    inp2 = cat([layer(sp, m.g_s2, inp3), conds[1]], dim=-1)
    inp1 = cat([layer(sp, m.g_s1, inp2), conds[0]], dim=-1)
    return {"out1": layer(sp, m.g_o1, inp1), "out2": layer(sp, m.g_o2, inp2),
            "out3": layer(sp, m.g_o3, inp3), "likelihoods": likelihoods}


def offset_diversity_forward(sp: Spatial, m, x1: Rows, head1: Rows, flow1: Rows, x2: Rows,
                             head2: Rows, flow2: Rows) -> Rows:
    """``OffsetDiversity.forward``: the per-pixel ``_prep`` of each head on
    the local rows, then the sharded deform conv."""
    off1, m1 = _per_pixel(m._prep, head1, flow1)
    off2, m2 = _per_pixel(m._prep, head2, flow2)
    return sp.deform(cat([x1, x2], dim=-1), cat([off1, off2], dim=-1), cat([m1, m2], dim=-1),
                     m.DeformConv_0)


def _b_frame_totals(sp: Spatial, x_hat: Rows, xcur: Rows, off: dict, res: dict) -> dict:
    liks = list(off["likelihoods"].values()) + list(res["likelihoods"].values())
    bits, per_sample = sp.bits(liks)
    total = sum(bits)
    return {"x_hat": x_hat, "bits": total, "size": total, "sizes": sum(per_sample),
            "rate": total / (xcur.x.shape[0] * xcur.H * xcur.x.shape[2])}


def flowguided_b_forward(sp: Spatial, m, x_before: Rows, x_current: Rows, x_after: Rows, s,
                         scale1=0.5, scale2=-0.5, down_ratio: int = 1) -> dict:
    """``FlowGuidedB.forward(x_before, x_after, x_current, s, scale1, scale2,
    down_ratio, "dequantize")``: the references are x_before and x_after."""
    xref1, xref2, xcur = x_before, x_after, x_current
    scale1, scale2 = convert_scales(scale1, scale2)
    # estimate_flow
    d1 = sp.pool(xref1, down_ratio * 2)
    d2 = sp.pool(xref2, down_ratio * 2)
    h, w = d1.H, d1.x.shape[2]
    d1 = sp.pad_to_multiple(d1, 16, mode="constant")[0]
    d2 = sp.pad_to_multiple(d2, 16, mode="constant")[0]
    flow = sp.unpad(flownet_forward(sp, m.flow_estimator, cat([d1, d2], dim=-1)), (h, w))
    if down_ratio > 1:
        flow = sp.resize(flow, h * down_ratio, w * down_ratio).map(lambda t: t * down_ratio)

    fref1 = ms_feature_forward(sp, m.feature_extractor, xref1)
    fref2 = ms_feature_forward(sp, m.feature_extractor, xref2)
    cond, flows = [], []
    for i in range(3):  # warped_refs_at_layer
        f1 = flow.map(lambda t: torch.chunk(t, 2, dim=-1)[0] * scale1)
        f2 = flow.map(lambda t: torch.chunk(t, 2, dim=-1)[1] * scale2)
        w1, w2 = sp.warp(fref1[i], f1), sp.warp(fref2[i], f2)
        cond.append(cat([w1, w2, fref1[i], fref2[i]], dim=-1))
        flows.append((f1, f2))
        if i < 2:  # the last level's halved flow is not used
            flow = sp.resize(flow, flow.H // 2, flow.x.shape[2] // 2).map(lambda t: t * 0.5)
    offset_temp = temporal_enc_forward(sp, m.offset_temporal_conditioner, *cond)

    fcur = ms_feature_forward(sp, m.feature_extractor, xcur)
    inputs = [cat([c, f], dim=-1) for c, f in zip(cond, fcur)]
    off = cond_elic_forward(sp, m.offset_compressor, inputs, cond, offset_temp, s)
    divs = (m.offset_diversity_l1, m.offset_diversity_l2, m.offset_diversity_l3)
    x_comp = []
    for i in range(3):
        o1, o2 = _split_channels(off[f"out{i + 1}"])
        x_comp.append(offset_diversity_forward(sp, divs[i], fref1[i], o1, flows[i][0],
                                               fref2[i], o2, flows[i][1]))
    res_temp = temporal_enc_forward(sp, m.residue_temporal_conditioner, *x_comp)
    res_inputs = [cat([f, xc], dim=-1) for f, xc in zip(fcur, x_comp)]
    res = cond_elic_forward(sp, m.residual_compressor, res_inputs, x_comp, res_temp, s)
    x_hat = reconstructor_forward(sp, m.reconstructor, *(
        xc.map(torch.add, res[f"out{i + 1}"]) for i, xc in enumerate(x_comp)))
    return _b_frame_totals(sp, x_hat, xcur, off, res)


def _split_channels(x: Rows) -> tuple[Rows, Rows]:
    """The two halves of the channels."""
    return tuple(x.map(lambda t, i=i: torch.chunk(t, 2, dim=-1)[i]) for i in (0, 1))


def deform_b_forward(sp: Spatial, m, x_before: Rows, x_current: Rows, x_after: Rows,
                     s) -> dict:
    """``DeformB.forward(x_before, x_after, x_current, s, "dequantize")``:
    each level's two deform convs (``_deform_pair``) through the sharded
    deform, the residual codec's pixel stage on x_current."""
    xref1, xref2, xcur = x_before, x_after, x_current
    fref1 = ms_feature_forward(sp, m.feature_extractor, xref1)
    fref2 = ms_feature_forward(sp, m.feature_extractor, xref2)
    cond = [cat([r1, r2], dim=-1) for r1, r2 in zip(fref1, fref2)]
    offset_temp = temporal_enc_forward(sp, m.offset_temp_encoder, *cond)
    fcur = ms_feature_forward(sp, m.feature_extractor, xcur)
    inputs = [cat([c, f], dim=-1) for c, f in zip(cond, fcur)]
    off = cond_elic_forward(sp, m.offset_compressor, inputs, cond, offset_temp, s)
    x_comp = []
    for i in range(3):  # _deform_pair
        aligned = []
        for ref, (f, head) in enumerate(zip((fref1[i], fref2[i]),
                                            _split_channels(off[f"out{i + 1}"])), 1):
            offsets, masks = _per_pixel(_head_to_deform, head)
            aligned.append(sp.deform(f, offsets, masks,
                                     getattr(m, f"deconv_l{i + 1}_{ref}")))
        x_comp.append(cat(aligned, dim=-1))
    res_inputs = [cat([f, xc], dim=-1) for f, xc in zip(fcur, x_comp)]
    res_temp = temporal_enc_forward(sp, m.residual_temp_encoder, *x_comp)
    res = cond_elic_forward(sp, m.residual_compressor, res_inputs, x_comp, res_temp, s,
                            x_pixel=xcur)
    x_hat = reconstructor_forward(sp, m.reconstructor, *(
        xc.map(torch.add, res[f"out{i + 1}"]) for i, xc in enumerate(x_comp)))
    return _b_frame_totals(sp, x_hat, xcur, off, res)


def _zeros(like: Rows, channels: int) -> Rows:
    """Zeros of ``like``'s rows with ``channels`` channels (a prior or DPB
    entry a first P-frame lacks)."""
    return like.map(lambda t: torch.zeros(t.shape[:3] + (channels,), dtype=t.dtype,
                                          device=t.device))


def four_part_forward(sp: Spatial, c, y: Rows, ctx: Rows | None, q=0.0) -> tuple:
    """``_FourPartCoder.forward(y, ctx, "dequantize", q=q)``: the gained
    hyper analysis, the bottleneck, the fused hyper and temporal prior (a
    zero prior without ``ctx``), four parts through the adaptors, each
    part's mask at the parity of the rank's first row, the inverse gain.
    -> (y_hat, {"y", "z"} likelihoods of this rank's rows)."""
    y = y.map(lambda t: t * c._interp(c.gain, q))
    z = _chain(sp, c, y, ("h_a1", "h_a2", "h_a3"), F.relu)
    z_hat, z_lik = _per_pixel(lambda t: c.entropy_bottleneck(t, "dequantize"), z)
    p = _chain(sp, c, z_hat, ("h_s1", "h_s2", "h_s3"), F.relu)
    t = _chain(sp, c, _zeros(p, c.N) if ctx is None else ctx, ("t_prior1", "t_prior2"), F.relu)
    params0 = _chain(sp, c, cat([p, t], dim=-1), ("fusion1", "fusion2"), F.relu)
    y0 = sp.rows(y.H)[0]
    y_hat, y_lik = y.map(torch.zeros_like), y.map(torch.ones_like)
    for k in range(4):
        params = params0 if k == 0 else layer(sp, c.adaptors[k - 1],
                                              cat([params0, y_hat], dim=-1))
        y_hat, y_lik = _per_pixel(
            lambda yt, yh, yl, pt, k=k: c.code_part(yt, yh, yl, split_params(pt), k,
                                                    "dequantize", y0=y0),
            y, y_hat, y_lik, params)
    return y_hat.map(lambda t: c.apply_inv_gain(t, q)), {"y": y_lik.x, "z": z_lik.x}


def estimate_mv(sp: Spatial, m, x: Rows, ref: Rows, ratio: float) -> Rows:
    """``PFrameDMC.estimate_mv``: SPyNet at ratio 1; else both frames
    resized (antialiased) to ``down_size``, edge-padded to x64 (the layout
    goes from the h rows' to the padded rows'), SPyNet, cropped, resized
    back to H and scaled by W / w. The resizes run whole on every rank."""
    if ratio == 1.0:
        return spynet_forward(sp, m.optic_flow, x, ref)
    H, W = x.H, x.x.shape[2]
    h, w = down_size(H, W, ratio)
    xd = sp.pad_to_multiple(sp.resize_antialias(x, h, w), 64, mode="edge")[0]
    rd = sp.pad_to_multiple(sp.resize_antialias(ref, h, w), 64, mode="edge")[0]
    mv = sp.unpad(spynet_forward(sp, m.optic_flow, xd, rd), (h, w))
    # the flow's resize runs whole, as the frames' (Spatial.resize_antialias)
    return sp.whole(mv, lambda t: bilinear_resize(t, H, W)).map(lambda t: t * (W / w))


def dmc_forward(sp: Spatial, m, x: Rows, dpb: dict, ratio: float = 1.0, q=0.0) -> dict:
    """``PFrameDMC.forward(x, dpb, ratio, "dequantize", q=q)`` of one
    P-frame: the flow (:func:`estimate_mv`), ``code_mv``,
    ``motion_compensate`` (the 48-channel feature map and the reference
    warped, ``exact``), ``code_frame``. ``dpb`` holds :class:`Rows` (or
    None, or lacks an entry: a first P-frame after an I-frame); the updated
    DPB comes back as :class:`Rows`, ready for the next sharded P-frame."""
    ref_frame = dpb["ref_frame"]
    est_mv = estimate_mv(sp, m, x, ref_frame, ratio)
    # code_mv; the analysis's first conv (10 channels in, at full resolution)
    # runs whole: cuDNN sums its windows otherwise on the H100 (PERF.md §6)
    mv_feat = dpb.get("ref_mv_feature")
    y = cat([est_mv.map(lambda t: t / ratio),
             _zeros(est_mv, MV_FEAT) if mv_feat is None else mv_feat], dim=-1)
    y = sp.whole(y, m.mv_g_a[0]).map(L.leaky_relu)
    mv_y_hat, mv_lik = four_part_forward(sp, m.mv_coder, _run(sp, m.mv_g_a[1:], y, L.leaky_relu),
                                         dpb.get("ref_mv_y"), q)
    mv_feature = mv_y_hat
    for lay in m.mv_g_s:
        mv_feature = layer(sp, lay, mv_feature).map(L.leaky_relu)
    mv_hat = layer(sp, m.mv_out, mv_feature).map(lambda t: t * ratio)
    # motion_compensate
    ref_feature = dpb.get("ref_feature")
    f = _run(sp, [m.feat_in, *m.feat_blocks],
             cat([ref_frame, _zeros(ref_frame, m.feat) if ref_feature is None else ref_feature],
                 dim=-1))
    warped_f = sp.warp(f, mv_hat)
    warped_x = sp.warp(ref_frame, mv_hat)
    context = _run(sp, m.ctx_refine, cat([warped_f, warped_x, mv_hat], dim=-1))
    # code_frame
    y_hat, y_lik = four_part_forward(sp, m.y_coder, _run(sp, m.g_a_layers,
                                                         cat([x, context], dim=-1)),
                                     dpb.get("ref_y"), q)
    feature = _run(sp, m.recon_head,
                   cat([_run(sp, m.g_s_layers, y_hat), context], dim=-1))
    x_hat = layer(sp, m.to_rgb, feature)
    bits, per_sample = sp.bits(list(mv_lik.values()) + list(y_lik.values()))
    bits_mv, bits_y = sum(bits[:len(mv_lik)]), sum(bits[len(mv_lik):])
    total = bits_mv + bits_y
    return {
        "x_hat": x_hat, "warped": warped_x, "bits": total, "bits_mv": bits_mv,
        "bits_y": bits_y, "sizes": sum(per_sample),
        "rate": total / (x.x.shape[0] * x.H * x.x.shape[2]),
        "dpb": {"ref_frame": x_hat.map(lambda t: clip(t, 0.0, 1.0)), "ref_feature": feature,
                "ref_mv_feature": mv_feature, "ref_y": y_hat, "ref_mv_y": mv_y_hat,
                "ref_down_ratio": ratio},
    }


def elic_forward(sp: Spatial, m, x: Rows) -> dict:
    """``ELIC.forward(x, "dequantize")`` (``stage2=False``): g_a, h_a, the
    bottleneck, h_s from round(z), each group's checkerboard and channel
    context and Gaussian, g_s from round(y)."""
    y = _run(sp, m.g_a_layers, x)
    z = _run(sp, m.h_a_layers, y, F.relu)
    likelihoods = {"z": _per_pixel(lambda t: m.entropy_bottleneck(t, "dequantize"), z)[1].x}
    hyper = _run(sp, m.h_s_layers, z.map(ste_round), F.relu)

    def gaussian(t, params):
        scales, means = torch.chunk(params, 2, dim=-1)
        return m.gaussian(t, scales, means=means, mode="dequantize")

    bounds = np.cumsum((0,) + tuple(m.groups))
    groups_hat = []
    for i in range(len(m.groups)):
        curr_y = y.map(lambda t, i=i: t[..., bounds[i]:bounds[i + 1]])
        curr_y_hat = curr_y.map(lambda t: quantize(t, "dequantize"))
        prev = cat(groups_hat, dim=-1) if i > 0 else None
        params = _group_params(sp, m, i, curr_y_hat, prev, hyper)
        likelihoods[f"y_{i}"] = _per_pixel(gaussian, curr_y, params)[1].x
        groups_hat.append(curr_y_hat)
    bits, per_sample = sp.bits(list(likelihoods.values()))
    return {"x_hat": _run(sp, m.g_s_layers, y.map(ste_round)), "bits": sum(bits),
            "sizes": sum(per_sample)}


#: Each family's sharded forward, by its model's class.
FORWARDS = ((LHBDC, lhbdc_forward), (FlowGuidedB, flowguided_b_forward),
            (DeformB, deform_b_forward), (BidirFlowRef, flexrate_forward),
            (PFrameDMC, dmc_forward), (ELIC, elic_forward))


@torch.no_grad()
def spatial_forward(mesh: Mesh, model, *inputs, mode: str = "dequantize",
                    stats: SpatialStats | None = None, **family_args) -> dict:
    """The model's ``dequantize`` forward with the frames' rows sharded over
    ``mesh`` (inputs from :func:`shard_spatial`), by its class, on each
    family's own positional inputs:

    - B-frames ``(x_before, x_current, x_after)``: LHBDC; FlowGuidedB
      (``family_args``: ``s`` and, as its forward's defaults,
      ``scale1=0.5``, ``scale2=-0.5``, ``down_ratio=1``); DeformB (``s``);
      Flex-Rate's BidirFlowRef (``n`` and ``l=1.0``);
    - a P-frame ``(x, dpb)``: PFrameDMC (``ratio=1.0``, ``q=0.0``), the DPB
      a dict of :class:`Rows` (``ref_frame`` at least);
    - an I-frame ``(x,)``: ELIC.

    Returns this rank's rows of ``x_hat`` (and LHBDC's ``x_pred``,
    Flex-Rate's ``x_comp``, DMC's ``warped`` and updated ``dpb``) as
    :class:`Rows`, and the bits summed over the ranks: ``bits`` (the total),
    ``sizes`` (per sample) and each family's own (LHBDC's ``bits_flow`` and
    ``bits_residual``, Flex-Rate's and v3/v4's ``size``, DMC's ``bits_mv``
    and ``bits_y``, ``rate``). ``stats`` (a :class:`SpatialStats`) records
    the fetches, warps and deform convs."""
    if mode != "dequantize":
        raise ValueError(f"the spatial forward runs mode='dequantize', not {mode!r}")
    for cls, forward in FORWARDS:
        if isinstance(model, cls):
            return forward(Spatial(mesh, stats), model, *inputs, **family_args)
    raise TypeError(f"no sharded forward for {type(model).__name__}")
