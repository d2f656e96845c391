"""Kodak-style still-image test sets for the intra (ELIC) codec (port of
tpuvc.data.kodak).

Parity: the reference's LHBDC/test/utils.py:206-228 (KodakTestDataset: a
flat folder of PNGs, normalized to [0,1], no padding in the dataset — the
codec pads). Here each item is the padded (1, H', W', 3) float32 numpy
array the models consume, padded on the host with tpuvc's reflect
geometry, with the unpadded size kept on the dataset (the eval crops back
before PSNR, matching the video protocol).
"""

from __future__ import annotations

import functools
import glob
import os

import numpy as np

from tpuvc_torch.data.frames import load_png, to_float
from tpuvc_torch.data.uvg import _pad_np


class ImageFolder:
    """Lazy indexable of padded (1, H', W', 3) images from a PNG folder.

    Images may have different sizes (Kodak mixes 768x512 / 512x768);
    ``size(i)`` is image i's unpadded (H, W).
    """

    def __init__(self, directory: str, multiple: int = 64,
                 cache_size: int = 4):
        self.paths = sorted(glob.glob(os.path.join(directory, "*.png")))
        assert self.paths, f"no images in {directory}"
        self._multiple = multiple
        self._load = functools.lru_cache(maxsize=cache_size)(
            self._load_uncached
        )
        self._sizes: dict[int, tuple[int, int]] = {}

    def __len__(self):
        return len(self.paths)

    def _load_uncached(self, idx: int) -> np.ndarray:
        img = to_float(load_png(self.paths[idx]))[None]
        self._sizes[idx] = img.shape[1:3]
        return _pad_np(img, self._multiple)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self._load(idx)

    def size(self, idx: int) -> tuple[int, int]:
        if idx not in self._sizes:
            self._load(idx)
        return self._sizes[idx]


class SyntheticImages:
    """Random test images with the same interface (CI / no-dataset runs),
    from a numpy seed."""

    def __init__(self, n: int = 3, h: int = 128, w: int = 192, seed: int = 0,
                 multiple: int = 64):
        rng = np.random.default_rng(seed)
        self._images = [
            rng.random((h, w, 3), dtype=np.float32) for _ in range(n)
        ]
        self._hw = (h, w)
        self._multiple = multiple

    def __len__(self):
        return len(self._images)

    def __getitem__(self, idx: int) -> np.ndarray:
        return _pad_np(self._images[idx][None], self._multiple)

    def size(self, idx: int) -> tuple[int, int]:
        return self._hw
