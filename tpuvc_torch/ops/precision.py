"""Compute-dtype policy for the codec transforms (port of tpuvc.ops.precision).

Convolutions and GDN's channel mixing run in the policy dtype (bfloat16 under
:func:`mixed_precision`); everything between them — flow arithmetic, warp
coordinates, entropy parameters, likelihoods — stays float32. Parameters stay
float32, so one checkpoint serves both modes.

PyTorch runs eagerly, so the policy is read when a layer *runs* (tpuvc reads
it at trace time). It is a ``contextvars`` variable: worker threads see the
submitter's policy only through :class:`tpuvc_torch.coder.parallel.CtxPool`.

Encoder and decoder must compute identically (the decoder re-estimates flow
from reconstructions), so coding on CUDA also needs :func:`set_deterministic`:
fixed cuDNN heuristics, TF32 off, and conv plans that do not depend on the
card's free memory (:data:`CONV_WORKSPACE_GIB`). Training on CUDA adds
PyTorch's deterministic algorithms (:func:`deterministic_training`).
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import math
import os
import threading

import torch

from tpuvc_torch import obs

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


#: cuDNN's convolution workspace budget, GiB. PyTorch runs a conv through
#: the first plan of cuDNN's heuristic list whose workspace it can allocate
#: and passes over a plan whose allocation fails, so on a card that other
#: work shares, free memory would pick the plan, and with it the order the
#: conv sums in. Instead :func:`conv` fixes each conv shape's plan, the first
#: time the process runs it, to the first plan whose workspace fits the
#: budget, whatever else holds the card: on every card that can give the
#: process its own needs plus the budget, the same plan. Part of the stream
#: contract: an encoder and a decoder with different budgets may compute
#: different floats.
CONV_WORKSPACE_GIB = 4



class ConvWorkspaceError(RuntimeError):
    """The card cannot give the process its conv-workspace budget."""


class _Plans:
    """The conv shapes whose plan each thread has fixed (PyTorch keeps a
    cuDNN plan cache per thread), and the gate that lets a plan-fixing
    window run while no other thread does device work beside it.

    Device work runs beside other device work only through the coders'
    worker pools (:class:`tpuvc_torch.coder.parallel.CtxPool`), so a thread
    *holds* the gate while it runs a pool task, and while pool tasks it
    submitted have not finished (it may work on the card beside them). A
    holder *parks* (holds it no longer) while it waits on a pool's future
    or shutdown, and at a conv while a window waits or is open. A window
    (``exclusive``) waits until every other holder has parked or ended, and
    no holder resumes until the waiting windows have run: the window's cap
    and allocations then meet no other thread's. (A thread that holds
    nothing, such as autograd's device thread re-running a checkpointed
    forward while its caller waits, runs no device work beside another.)"""

    def __init__(self):
        self.local = threading.local()
        self.cond = threading.Condition()
        self.holds: dict = {}  # thread -> its running task + its unfinished submissions
        self.parks: dict = {}  # thread -> depth of its parked waits
        self.waiting = 0  # windows waiting to open
        self.fixing = False  # a window is open
        self.threshold = None  # bytes, while a window is open
        self.observed = False
        self.fraction: dict = {}  # device index -> the process's own cap

    @property
    def seen(self) -> set:
        """This thread's conv shapes with a fixed plan."""
        if not hasattr(self.local, "seen"):
            self.local.seen = set()
        return self.local.seen

    def _running(self, t) -> bool:
        return self.holds.get(t, 0) > 0 and not self.parks.get(t, 0)

    def _wait_out_windows(self, me) -> None:
        """Under ``cond``: a holder about to run again waits for the windows."""
        if self.holds.get(me, 0):
            while self.fixing or self.waiting:
                self.cond.wait()

    def hold(self) -> None:
        """This thread holds the gate once more (it starts a pool task, or
        submitted one); waits out the windows first if it was not running."""
        me = threading.current_thread()
        with self.cond:
            if not self._running(me) and not self.parks.get(me, 0):
                while self.fixing or self.waiting:
                    self.cond.wait()
            self.holds[me] = self.holds.get(me, 0) + 1

    def release(self, thread) -> None:
        """``thread`` holds the gate once less (its task, or one it submitted,
        finished)."""
        with self.cond:
            self.holds[thread] -= 1
            if not self.holds[thread]:
                del self.holds[thread]
            self.cond.notify_all()

    @contextlib.contextmanager
    def shared(self):
        """Hold the gate for the enclosed device work."""
        self.hold()
        try:
            yield
        finally:
            self.release(threading.current_thread())

    @contextlib.contextmanager
    def parked(self):
        """Hold the gate no longer during the enclosed wait."""
        me = threading.current_thread()
        with self.cond:
            self.parks[me] = self.parks.get(me, 0) + 1
            self.cond.notify_all()
        try:
            yield
        finally:
            with self.cond:
                try:
                    if self.parks[me] == 1:
                        self._wait_out_windows(me)
                finally:
                    self.parks[me] -= 1
                    if not self.parks[me]:
                        del self.parks[me]

    def checkpoint(self) -> None:
        """At a conv on a card: park while a window waits or is open."""
        if self.waiting or self.fixing:
            with obs.span("plan.park"), self.parked():
                with self.cond:
                    while self.fixing:
                        self.cond.wait()

    @contextlib.contextmanager
    def exclusive(self):
        """A window: the enclosed code runs while every other holder is
        parked or has ended."""
        me = threading.current_thread()
        with self.parked():
            with obs.span("plan.wait"), self.cond:
                self.waiting += 1
                try:
                    while self.fixing or any(t is not me and t.is_alive() and self._running(t)
                                             for t in self.holds):
                        self.cond.wait(0.05)  # a holder that ended notifies no one
                finally:
                    self.waiting -= 1
                self.fixing = True
            try:
                yield
            finally:
                with self.cond:
                    self.fixing = False
                    self.cond.notify_all()


_PLANS = _Plans()


def _refuse_other_plans(device: int, alloc: int, allocated: int, free: int) -> None:
    """PyTorch's out-of-memory observer. Inside a plan-fixing window an
    allocation above the window's threshold (the budget) is a plan whose
    workspace exceeds what the window can give on any card, and cuDNN
    passes it over. Any other failed
    allocation raises instead of letting cuDNN take a plan with a smaller
    workspace: it fails only where the card holds less than the process's
    needs plus the budget, and the conv would then sum otherwise than at the
    stream's other end."""
    threshold = _PLANS.threshold
    if threshold is not None and alloc > threshold:
        return
    raise ConvWorkspaceError(
        f"cuda:{device} is out of memory allocating {alloc / 2**30:.2f} GiB "
        f"({free / 2**30:.2f} GiB free): tpuvc_torch needs its own peak plus "
        f"{CONV_WORKSPACE_GIB} GiB of cuDNN conv workspace, and stops rather than "
        f"run a conv through another plan than the encoder or decoder at the "
        f"stream's other end")


def pin_conv_workspace(device=None) -> None:
    """Hold this process's conv plans to :data:`CONV_WORKSPACE_GIB`.

    On a card: refuses to start unless the card can give the budget now
    (free memory plus what this process holds cached); keeps the caching
    allocator from splitting blocks of the budget's size or more (so no
    cached block can hold a workspace above the budget), and makes any
    device allocation that fails outside :func:`conv`'s plan-fixing window
    raise :class:`ConvWorkspaceError` rather than fall back to another conv
    plan. ``device`` None is the current card if there is one. Calling it
    again changes nothing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return
    free, _ = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    have = (free + cached) / 2**30
    if have < CONV_WORKSPACE_GIB:
        raise ConvWorkspaceError(
            f"tpuvc_torch needs {CONV_WORKSPACE_GIB} GiB of free device memory on "
            f"{dev} for cuDNN's conv workspace and has {have:.2f} GiB: with less, "
            f"cuDNN would run other conv plans than the encoder or decoder at the "
            f"stream's other end. Free the card and start again")
    if not _PLANS.observed:
        _allocator_settings(f"max_split_size_mb:{int(CONV_WORKSPACE_GIB * 1024)}")
        torch._C._cuda_attach_out_of_memory_observer(_refuse_other_plans)
        _PLANS.observed = True


def _allocator_settings(settings: str) -> None:
    """PyTorch's caching-allocator settings (``PYTORCH_CUDA_ALLOC_CONF``'s
    syntax), at run time."""
    torch._C._accelerator_setAllocatorSettings(settings)


def cap_device_memory(gib, device=None) -> None:
    """Cap this process's device memory (PyTorch's caching allocator) at
    ``gib`` GiB of the card's, or lift the cap with None; :func:`conv`'s
    windows keep within it. The process's unused cached memory (garbage
    collected first) goes back to the card before the cap applies, so what
    earlier work left cached does not count against it."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _hand_back(index)
    total = torch.cuda.get_device_properties(index).total_memory
    fraction = 1.0 if gib is None else min(1.0, gib * 2**30 / total)
    _PLANS.fraction[index] = fraction
    torch.cuda.set_per_process_memory_fraction(fraction, index)


def _hand_back(index: int) -> None:
    """Return this process's unused cached device memory to the card, after
    collecting garbage that still holds tensors."""
    gc.collect()
    torch.cuda.synchronize(index)
    torch.cuda.empty_cache()


def _conv_out_shape(x, weight, transposed, stride, padding, output_padding) -> tuple:
    """NCHW output shape of F.conv2d / F.conv_transpose2d (dilation 1)."""
    pair = lambda v: (v, v) if isinstance(v, int) else tuple(v)  # noqa: E731
    (sh, sw), (ph, pw), (oh, ow) = pair(stride), pair(padding), pair(output_padding)
    kh, kw = weight.shape[2:]
    H, W = x.shape[2:]
    if transposed:
        return (x.shape[0], weight.shape[1], (H - 1) * sh - 2 * ph + kh + oh,
                (W - 1) * sw - 2 * pw + kw + ow)
    return (x.shape[0], weight.shape[0], (H + 2 * ph - kh) // sh + 1,
            (W + 2 * pw - kw) // sw + 1)


def conv(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1, padding=0,
         output_padding=None) -> torch.Tensor:
    """``F.conv2d`` (``F.conv_transpose2d`` with ``output_padding``) of the
    NCHW ``x``, with its cuDNN plan fixed to the workspace budget.

    A thread's first call of a conv shape on a card (shapes, strides,
    dtype, the operands' alignment: what keys PyTorch's plan cache, which
    is per thread) runs in a window, while every other thread's device
    work is parked (:class:`_Plans`): the allocator's unused segments
    handed back, blocks the size of the call's output and of the operand
    copies PyTorch makes (channels-last) set aside in its cache for them,
    and the process capped at what it then holds plus the budget. PyTorch
    allocates the output and the copies (from those blocks) before the
    workspace, so a workspace must come from fresh memory under the cap
    (the allocator splits no cached block of the budget's size or more): a
    plan whose workspace exceeds the budget cannot be allocated on any
    card, and cuDNN passes it over; a plan within the budget is allocated
    unless the card itself is short, which raises
    (:func:`_refuse_other_plans`). PyTorch keeps the plan chosen for the
    thread's later calls of the shape. A later call whose allocation fails
    hands the process's unused cached memory back and runs once more, on
    the same plan, before the error stands."""
    import torch.nn.functional as F

    transposed = output_padding is not None
    if transposed:
        def run():
            return F.conv_transpose2d(x, weight, bias, stride=stride, padding=padding,
                                      output_padding=output_padding)
    else:
        def run():
            return F.conv2d(x, weight, bias, stride=stride, padding=padding)
    if x.device.type != "cuda":
        return run()
    key = (transposed, x.device.index, tuple(x.shape), x.stride(), x.dtype,
           x.data_ptr() % 16, tuple(weight.shape), weight.stride(), weight.dtype,
           weight.data_ptr() % 16, stride, padding, output_padding,
           torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    _PLANS.checkpoint()
    if key in _PLANS.seen:
        return _run_fixed(run, index)
    out = _conv_out_shape(x, weight, transposed, stride, padding, output_padding or 0)
    own = [math.prod(out) * x.element_size()]
    own += [t.numel() * t.element_size() for t in (x, weight)
            if not t.is_contiguous(memory_format=torch.channels_last)]
    return _fix_plan(run, key, index, own)


def _run_fixed(run, index: int):
    """``run()``, a conv whose plan this thread has fixed; where an
    allocation fails, once more after handing the cache back on card
    ``index`` (the same plan: the observer's error leaves PyTorch's plan
    cache as it was)."""
    try:
        return run()
    except ConvWorkspaceError:
        _hand_back(index)
        return run()


def _fix_plan(run, key, index: int, own: list):
    """``run()``, this thread's first call of the conv ``key`` on card
    ``index``, in :func:`conv`'s window; ``own``: the byte sizes of the
    call's output and of copies of its operands, set aside in the cache."""
    with _PLANS.exclusive(), obs.span("plan.fix"):
        if key in _PLANS.seen:
            return run()
        obs.count("plan.windows")
        torch.cuda.empty_cache()
        staged = [torch.empty(n, dtype=torch.uint8, device=f"cuda:{index}") for n in own]
        del staged
        total = torch.cuda.get_device_properties(index).total_memory
        budget = int(CONV_WORKSPACE_GIB * 2**30)
        process = _PLANS.fraction.get(index, 1.0)
        cap = min(process, (torch.cuda.memory_reserved(index) + budget) / total)
        torch.cuda.set_per_process_memory_fraction(cap, index)
        _PLANS.threshold = budget
        try:
            y = run()
        finally:
            _PLANS.threshold = None
            torch.cuda.set_per_process_memory_fraction(process, index)
        _PLANS.seen.add(key)
        return y


def set_deterministic(device=None) -> None:
    """Process-wide settings that make encode and decode compute alike on CUDA.

    cuDNN picks its algorithms by fixed heuristics (no autotuning race) and
    only deterministic ones, each conv's the first that fits the
    conv-workspace budget (:func:`pin_conv_workspace`, :func:`conv`;
    ``device`` is the card to check, the current one by default, none for a
    CPU device); TF32 is off, so the float32 parts of the policy really are
    float32.
    """
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pin_conv_workspace(device)


#: cuBLAS's deterministic workspace setting, which PyTorch's deterministic
#: mode asks for before it runs a cuBLAS call.
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


@contextlib.contextmanager
def deterministic_training(device=None):
    """:func:`set_deterministic` and PyTorch's deterministic algorithms for
    the enclosed code, so two training runs from one seed and one batch
    stream give the same bits.

    The warp's and the deform conv's backward sum each pixel's samples
    with ``index_select``'s backward, an ``index_add`` that adds with float
    atomics on a card unless this mode is on (it then sorts the pixels);
    the mode does the same for every other such op (the pads' gathers),
    and makes an op with no deterministic version raise."""
    set_deterministic(device)
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in (":4096:8", ":16:8"):
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE_CONFIG
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
