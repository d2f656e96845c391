"""Threaded host coding of independent per-frame rANS streams, and the
coders' symbol transfers between device and host.

The level-batched coders produce one independent stream set per frame; the
ctypes rANS calls release the GIL, so a thread pool codes them concurrently.
Pools are created at first use and closed by :func:`shutdown`.

The decoders' entropy decode is stepwise: a generator that issues its
device work on the calling thread and yields at each host round trip
(:func:`host_step`); :func:`run_steps` drives one such decode to its end,
or several in turn, so that one's rANS runs while another's device work
does.
"""

from __future__ import annotations

import contextvars
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from tpuvc_torch import obs
from tpuvc_torch.ops import precision

_POOL: ThreadPoolExecutor | None = None
_ASYNC_POOL: ThreadPoolExecutor | None = None
_LOCK = threading.Lock()


class CtxPool(ThreadPoolExecutor):
    """ThreadPoolExecutor that runs each task under a copy of the
    SUBMITTER's contextvars context.

    The compute-dtype policy (tpuvc_torch.ops.precision) is a contextvar; a
    bare worker thread would run the decoder's entropy-parameter network in
    float32 while the encoder ran it in bfloat16 — a silent enc/dec mismatch
    that desyncs the rANS decode. Each task gets its own Context copy (a
    Context can be entered by one thread at a time).

    Each task holds the conv-plan gate (``ops.precision``) while it runs,
    and its submitter until it finishes; a wait on its future or on the
    pool's shutdown parks the waiting thread: a plan-fixing window then
    waits for the device work that runs, and never for a thread that waits
    for one of the tasks."""

    def submit(self, fn, /, *args, **kwargs):
        ctx = contextvars.copy_context()
        me = threading.current_thread()
        precision._PLANS.hold()
        try:
            fut = super().submit(ctx.run, _holding, fn, *args, **kwargs)
        except BaseException:
            precision._PLANS.release(me)
            raise
        fut.add_done_callback(lambda _: precision._PLANS.release(me))
        return _ParkingFuture(fut)

    def map(self, fn, *iterables, timeout=None, chunksize=1):
        ctx = contextvars.copy_context()
        return super().map(
            lambda *a: ctx.copy().run(fn, *a),
            *iterables, timeout=timeout, chunksize=chunksize,
        )

    def shutdown(self, wait=True, *, cancel_futures=False):
        with precision._PLANS.parked():
            super().shutdown(wait, cancel_futures=cancel_futures)


def _holding(fn, *args, **kwargs):
    with obs.span("task"), precision._PLANS.shared():
        return fn(*args, **kwargs)


class _ParkingFuture:
    """A CtxPool task's future; its waits park the waiting thread's hold on
    the conv-plan gate."""

    __slots__ = ("_fut",)

    def __init__(self, fut):
        self._fut = fut

    def result(self, timeout=None):
        with obs.span("entropy.wait"), precision._PLANS.parked():
            return self._fut.result(timeout)

    def exception(self, timeout=None):
        with precision._PLANS.parked():
            return self._fut.exception(timeout)

    def __getattr__(self, name):
        return getattr(self._fut, name)


def fetch(t):
    """A device tensor of symbols, indexes or z, as a host array."""
    with obs.span("entropy.fetch"):
        a = t.cpu().numpy()
    obs.count("entropy.fetch_bytes", a.nbytes)
    return a


def upload(a, device, non_blocking: bool = False):
    """Decoded host symbols (an array, or a :func:`host_buffer`), as a
    tensor on ``device``; ``non_blocking``: without waiting for the device,
    from a pinned :func:`host_buffer`."""
    with obs.span("entropy.upload"):
        t = (a if torch.is_tensor(a) else torch.from_numpy(a)).to(device, non_blocking=non_blocking)
    obs.count("entropy.upload_bytes", t.numel() * t.element_size())
    return t


def host_buffer(shape, dtype, device):
    """An empty host tensor for decoded symbols to upload to ``device``: in
    pinned memory where that is a card, so the upload need not wait. Fill it
    through ``.numpy()``: a CPU tensor copy would wake PyTorch's intra-op
    threads, which then spin beside the decode's own."""
    return torch.empty(shape, dtype=dtype, pin_memory=torch.device(device).type == "cuda")


def host_step(job, t=None):
    """One host round trip of a stepwise decode (a generator; ``yield
    from`` it): start the copy of the device tensor ``t`` to pinned host
    memory without waiting, run ``job(the host array)`` on a worker once
    the copy has landed (``job()`` without ``t``), yield the worker's
    future, and return what ``job`` returned. The calling thread only
    issues the copy; the worker waits on a CUDA event recorded after it
    (a blocking-sync event: the wait sleeps, off the GIL, and leaves the
    cores to the calling thread's dispatch) and runs no device work."""
    if t is None:
        fut = async_pool().submit(job)
    else:
        with obs.span("entropy.fetch"):
            host = t.to("cpu", non_blocking=True)
            landed = None
            if t.device.type == "cuda":
                landed = torch.cuda.Event(blocking=True)
                landed.record(torch.cuda.current_stream(t.device))
        obs.count("entropy.fetch_bytes", host.numel() * host.element_size())

        def fetched_job():
            if landed is not None:
                landed.synchronize()
            return job(host.numpy())

        fut = async_pool().submit(fetched_job)
    yield fut
    return fut.result()


def run_steps(*steps) -> list:
    """Drive stepwise computations (generators that yield the futures of
    their host work, :func:`host_step`) to their ends on this thread; ->
    their results, in order. The one to resume is one whose future is done,
    else the one started first, whose wait then blocks. One step alone runs
    as its blocking form would."""
    out = [None] * len(steps)
    waiting: dict = {}

    def advance(k):
        try:
            waiting[k] = next(steps[k])
        except StopIteration as stop:
            waiting.pop(k, None)
            out[k] = stop.value

    for k in range(len(steps)):
        advance(k)
    while waiting:
        advance(next((k for k, fut in waiting.items() if fut.done()), min(waiting)))
    return out


def host_pool() -> ThreadPoolExecutor:
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = CtxPool(max_workers=min(8, os.cpu_count() or 4))
        return _POOL


def parallel_map(fn, items):
    """fn over items on the host pool, order-preserving."""
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    return list(host_pool().map(fn, items))


def async_pool() -> ThreadPoolExecutor:
    """Separate pool for the enc/dec async host phases (symbol fetches, rANS
    coding, the decoder's entropy-parameter network). Distinct from
    host_pool so a host phase that fans out into parallel_map cannot
    deadlock waiting for workers of its own pool."""
    global _ASYNC_POOL
    with _LOCK:
        if _ASYNC_POOL is None:
            _ASYNC_POOL = CtxPool(max_workers=4)
        return _ASYNC_POOL


def shutdown() -> None:
    """Wait for and close both pools; later calls create new ones."""
    global _POOL, _ASYNC_POOL
    with _LOCK:
        pools, _POOL, _ASYNC_POOL = (_ASYNC_POOL, _POOL), None, None
    for pool in pools:
        if pool is not None:
            pool.shutdown(wait=True)
