"""Sequence frame sources (port of tpuvc.data.uvg).

Frames are PNGs in one directory, in sorted order; loading is lazy and
cached per source, so long 1080p sequences never sit in host memory.
Frames stay uint8 on the host and are converted on the device
(:func:`device_frame`), which moves a quarter of the float bytes.
"""

from __future__ import annotations

import functools
import glob
import os

import numpy as np
import torch

from tpuvc_torch import obs
from tpuvc_torch.data.frames import load_png, to_float


def _pad_np(img: np.ndarray, multiple: int) -> np.ndarray:
    """Host reflection pad of (..., H, W, C) to multiples (the geometry of
    ops.pad.pad_to_multiple), keeping the dtype."""
    h, w = img.shape[-3], img.shape[-2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph == 0 and pw == 0:
        return img
    pad_width = [(0, 0)] * (img.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
    return np.pad(img, pad_width, mode="reflect")


def device_frame(u8: np.ndarray, device) -> torch.Tensor:
    """Upload a uint8 frame and convert it to float32 in [0, 1] on
    ``device`` (the values equal ``to_float`` on the host)."""
    with obs.span("frames.upload"):
        return torch.from_numpy(np.ascontiguousarray(u8)).to(device).float() / 255.0


class SequenceFrames:
    """Lazy indexable of padded (1, H', W', 3) frames of one sequence."""

    def __init__(self, directory: str, n_frames: int | None = None,
                 multiple: int = 64, cache_size: int = 8):
        self.paths = sorted(glob.glob(os.path.join(directory, "*.png")))
        if n_frames is not None:
            self.paths = self.paths[:n_frames]
        if not self.paths:
            raise FileNotFoundError(f"no frames in {directory}")
        self.multiple = multiple
        self.size = load_png(self.paths[0]).shape[:2]
        self._load = functools.lru_cache(maxsize=cache_size)(self._load_uncached)

    def __len__(self):
        return len(self.paths)

    def _load_uncached(self, idx: int) -> np.ndarray:
        return _pad_np(load_png(self.paths[idx])[None], self.multiple)

    def __getitem__(self, idx: int) -> np.ndarray:
        return to_float(self._load(idx))

    def u8(self, idx: int) -> np.ndarray:
        """Padded (1, H', W', 3) uint8; convert with ``device_frame``."""
        return self._load(idx)


class SyntheticSequence:
    """Synthetic drifting sequence with the same interface, from a numpy
    seed. Frames are uint8-quantized like PNG sources."""

    def __init__(self, n_frames: int = 17, h: int = 128, w: int = 192,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        base = rng.random((h, w, 3), dtype=np.float32)
        drift = 0.01 * rng.standard_normal((h, w, 3)).astype(np.float32)
        self.frames = [
            np.clip(np.rint(np.clip(base + i * drift, 0, 1) * 255), 0, 255)
            .astype(np.uint8)
            for i in range(n_frames)
        ]
        self.size = (h, w)

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx: int) -> np.ndarray:
        return to_float(self.u8(idx))

    def u8(self, idx: int) -> np.ndarray:
        return _pad_np(self.frames[idx][None], 64)
