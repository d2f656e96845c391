"""Taps on the program's stages, for the sampled sequence only.

The program codes a sequence in calls (chunks): a batch of I-frames
through ELIC, a batch of one hierarchy level's B-frames through the B
codec. For the sampled sequence, one I-call and one B-call are drawn from
the seed (a reservoir over the calls as they come), and every stage the
drawn call runs is recorded with its inputs and outputs, and so are the
call's own arguments: a stage is a
method of one of the model's submodules (``flownet.forward``,
``mv_compressor.synthesis``, ``g_s``...), named in the configuration. The
reference has the same modules under the same names, so the check runs the
reference's stage on the program's inputs. The frames a call codes are the
ones the program read last from the benchmark's
:class:`harness.frames.Sequence`: each call's batch is built from the
frames read just before it.
"""

from __future__ import annotations

import numpy as np
import torch


def _attr(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _snapshot(x):
    """A copy of a call's tensor arguments."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple):
        return tuple(_snapshot(v) for v in x)
    if isinstance(x, list):
        return [_snapshot(v) for v in x]
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    return x


def _batch(args) -> int:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.shape[0]
    raise ValueError("a coding call without a tensor argument")


class Tap:
    """``entries``: {"I" | "B": (object, method)}, the calls to draw from;
    ``stages``: {"I" | "B": (root module, [stage path, ...])}."""

    def __init__(self, seq, entries: dict, stages: dict, seed: int):
        self.seq = seq
        self.entries = entries
        self.stages = stages
        self.rng = np.random.default_rng((seed + 0x7A9) % 2**63)
        self.seen = {"I": 0, "B": 0}
        self.kept: dict = {}       # kind -> {"frames": [...], "calls": {stage: [(args, kw, out)]}}
        self._current: dict = {}  # kind -> the call being recorded, or None
        self._saved = []

    def wrap_entry(self, kind: str, fn):
        """A call of ``kind``: drawn or not as it starts; a drawn call's
        stages are recorded until the next call of its kind starts (ELIC's
        synthesis follows the coder's call)."""
        def entry(*a, **k):
            self.seen[kind] += 1
            self._current[kind] = None
            if self.rng.random() < 1.0 / self.seen[kind]:
                frames = list(self.seq.log[-_batch(a):]) if self.seq.log is not None else []
                self._current[kind] = self.kept[kind] = {"frames": frames, "entry": (a, k),
                                                         "calls": {}}
            return fn(*a, **k)
        return entry

    def wrap_stage(self, kind: str, name: str, fn):
        def stage(*a, **k):
            cur = self._current.get(kind)
            if cur is None:
                return fn(*a, **k)
            # The checkerboard coders write the anchors' latent they passed to
            # the context model after the call: keep a copy of those
            # arguments; every other stage's are kept as they are.
            copy = _snapshot if name.endswith("group_params") else (lambda x: x)
            args = (copy(a), copy(k))
            out = fn(*a, **k)
            cur["calls"].setdefault(name, []).append((*args, out))
            return out
        return stage

    def _patch(self, obj, attr, wrapper):
        own = attr in vars(obj)
        self._saved.append((obj, attr, own, vars(obj).get(attr)))
        setattr(obj, attr, wrapper(getattr(obj, attr)))

    def __enter__(self):
        self.seq.log = []
        for kind, (obj, attr) in self.entries.items():
            self._patch(obj, attr, lambda fn, kind=kind: self.wrap_entry(kind, fn))
        for kind, (root, paths) in self.stages.items():
            for path in paths:
                mod_path, _, meth = path.rpartition(".")
                obj = _attr(root, mod_path) if mod_path else root
                self._patch(obj, meth, lambda fn, kind=kind, path=path:
                            self.wrap_stage(kind, path, fn))
        return self

    def __exit__(self, *exc):
        for obj, attr, own, before in reversed(self._saved):
            if own:
                setattr(obj, attr, before)
            else:
                delattr(obj, attr)
        self._saved = []
        self.seq.log = None
        return False
