"""The port's spans and counters: what the host did, and when, inside each
coding and eval call.

Tracing is off by default: :func:`span` then costs one flag check and
returns a shared null context, :func:`count` nothing. It is on while
:func:`enable` has switched it on (the CLIs' ``--trace PATH``) and while any
``torch.profiler`` session records, so a profiled run gets the spans without
asking.

On, a span appends a :class:`Record` to an in-memory list, timed with
``time.time_ns()`` (the axis of the profiler's ``start_ns``), and under a
profiler also opens ``record_function("tpuvc." + name)``, so it shows in the
trace and device launches correlate to it. A span's parent and root come
from a context variable, which ``coder.parallel.CtxPool`` copies into each
worker task: a worker's spans hang under the span that submitted the task,
and every span of one call shares the call's root id.

Spans (``tpuvc.<name>``) and counters, and what reads them: PERF.md, §3.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import json
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

_ON = False
_NULL = contextlib.nullcontext()
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("tpuvc_torch_span", default=None)
_IDS = itertools.count(1)
_RECORDS: list = []
_COUNTS: dict = {}
_LOCK = threading.Lock()


class Record(NamedTuple):
    """One closed span: ids, the OS thread it ran on, its host interval
    (``time.time_ns()``) and the attributes it was given."""

    id: int
    parent: int | None
    root: int
    name: str
    thread: int
    t0_ns: int
    t1_ns: int
    attrs: dict | None = None


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "token", "fn", "t0")

    def __init__(self, name: str, attrs: dict | None):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        up = _CURRENT.get()
        self.id = next(_IDS)
        self.parent, self.root = (None, self.id) if up is None else up
        self.token = _CURRENT.set((self.id, self.root))
        self.fn = None
        self.t0 = time.time_ns()
        if _profiler._is_profiler_enabled:
            args = None if self.attrs is None else json.dumps(self.attrs)
            self.fn = torch.profiler.record_function("tpuvc." + self.name, args)
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self.fn is not None:
            self.fn.__exit__(*exc)
        t1 = time.time_ns()
        _CURRENT.reset(self.token)
        _RECORDS.append(Record(self.id, self.parent, self.root, self.name,
                               threading.get_ident(), self.t0, t1, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager timing the enclosed code as ``tpuvc.<name>``;
    ``attrs`` (level, batch, ...) are kept with the record."""
    if not (_ON or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, attrs or None)


def spanned(name: str):
    """Decorator form of :func:`span`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            if not (_ON or _profiler._is_profiler_enabled):
                return fn(*a, **k)
            with _Span(name, None):
                return fn(*a, **k)
        return inner
    return wrap


def stage(fn):
    """Decorator of a model stage, a module method: a span
    ``stage.<the module's path>.<method>`` in a model that
    :func:`name_stages` named (``stage.flownet.forward``,
    ``stage.motion_compensate`` on the model itself), none in another."""
    method = fn.__name__

    @functools.wraps(fn)
    def inner(self, *a, **k):
        if not (_ON or _profiler._is_profiler_enabled):
            return fn(self, *a, **k)
        path = self.__dict__.get("_stage_path")
        if path is None:
            return fn(self, *a, **k)
        with _Span(f"stage.{path}{method}", None):
            return fn(self, *a, **k)
    return inner


def name_stages(model: torch.nn.Module) -> None:
    """Give every module of ``model`` its attribute path for :func:`stage`."""
    for path, module in model.named_modules():
        module.__dict__["_stage_path"] = f"{path}." if path else ""


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing while tracing is off)."""
    if not (_ON or _profiler._is_profiler_enabled):
        return
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def records() -> list:
    """The closed spans since the last :func:`reset`, in closing order."""
    return list(_RECORDS)


def counters() -> dict:
    """The counters since the last :func:`reset`, with the hand kernels'
    launch counters (``ops.warp``, ``ops.deform``, ``ops.epilogue``; the
    deform launches that took its ``<V, MAXO>`` instance apart, the
    epilogue launches that applied an activation and those that left the
    residual add and activation to the plain ops), which count whether
    tracing is on or not."""
    from tpuvc_torch.ops import deform, epilogue, warp

    with _LOCK:
        out = dict(_COUNTS)
    out["warp.launches"] = warp.warp_kernel.launches
    out["deform.launches"] = deform.deform_kernel.launches
    out["deform.launches.wide"] = deform.deform_kernel.wide_launches
    out["epilogue.launches"] = epilogue.epilogue_kernel.launches
    out["epilogue.launches.act"] = epilogue.epilogue_kernel.act_launches
    out["epilogue.launches.partial"] = epilogue.epilogue_kernel.partial_launches
    return out


def reset() -> None:
    """Drop the records and counters (the launch counters stay)."""
    with _LOCK:
        _RECORDS.clear()
        _COUNTS.clear()


@contextlib.contextmanager
def tracing(path):
    """The CLIs' ``--trace PATH``: the enclosed run traced from a fresh
    record and dumped to ``path`` (None: nothing)."""
    if path is None:
        yield
        return
    reset()
    enable()
    try:
        yield
    finally:
        disable()
        dump(path)


def dump(path) -> None:
    """Write the records and counters to ``path`` as JSON:
    ``{"spans": [{"id", "parent", "root", "name", "thread", "t0_ns",
    "t1_ns", "attrs"}, ...], "counters": {...}}``."""
    doc = {"spans": [r._asdict() for r in records()], "counters": counters()}
    with open(path, "w") as f:
        json.dump(doc, f)
