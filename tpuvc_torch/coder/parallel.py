"""Threaded host coding of independent per-frame rANS streams, and the
coders' symbol transfers between device and host.

The level-batched coders produce one independent stream set per frame; the
ctypes rANS calls release the GIL, so a thread pool codes them concurrently.
Pools are created at first use and closed by :func:`shutdown`.
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


def upload(a, device):
    """Decoded host symbols, as a tensor on ``device``."""
    with obs.span("entropy.upload"):
        t = torch.from_numpy(a).to(device)
    obs.count("entropy.upload_bytes", a.nbytes)
    return t


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
