"""Threaded host coding of independent per-frame rANS streams.

The level-batched coders produce one independent stream set per frame; the
ctypes rANS calls release the GIL, so a thread pool codes them concurrently.
Pools are created at first use and closed by :func:`shutdown`.
"""

from __future__ import annotations

import contextvars
import os
import threading
from concurrent.futures import ThreadPoolExecutor

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
    Context can be entered by one thread at a time)."""

    def submit(self, fn, /, *args, **kwargs):
        ctx = contextvars.copy_context()
        return super().submit(ctx.run, fn, *args, **kwargs)

    def map(self, fn, *iterables, timeout=None, chunksize=1):
        ctx = contextvars.copy_context()
        return super().map(
            lambda *a: ctx.copy().run(fn, *a),
            *iterables, timeout=timeout, chunksize=chunksize,
        )


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
