"""Vimeo-90k septuplet training data (port of tpuvc.data.vimeo; numpy only).

Random triplets (LHBDC) or 5-frame windows (ICIP2024's recursive stage) from
each septuplet, random crops and flips. Host-side: threaded decode workers
and a background prefetch thread, with a sample stream that does not depend
on the worker count, and a synthetic fallback for machines without the
dataset. For a seed the batches equal tpuvc's byte for byte.
"""

from __future__ import annotations

import os

import numpy as np

from tpuvc_torch.data.frames import load_png, to_float


class VimeoSeptuplets:
    """Iterates septuplet directories: root/sequences/<a>/<b>/im{1..7}.png."""

    def __init__(self, root: str, list_file: str = "sep_trainlist.txt"):
        self.root = root
        path = os.path.join(root, list_file)
        with open(path) as f:
            self.items = [l.strip() for l in f if l.strip()]

    def __len__(self):
        return len(self.items)

    def load(self, idx: int, frame_ids) -> list[np.ndarray]:
        seq = os.path.join(self.root, "sequences", self.items[idx])
        return [
            load_png(os.path.join(seq, f"im{i}.png"))  # uint8
            for i in frame_ids
        ]


class SyntheticSeptuplets:
    """Fallback: drifting random textures with septuplet structure."""

    def __init__(self, n: int = 64, size: int = 288, seed: int = 0):
        self.n = n
        self.size = size
        self.seed = seed

    def __len__(self):
        return self.n

    def load(self, idx: int, frame_ids) -> list[np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        base = rng.random((self.size, self.size, 3), dtype=np.float32)
        drift = 0.02 * rng.standard_normal((self.size, self.size, 3)).astype(
            np.float32
        )
        return [
            np.clip(np.rint(np.clip(base + (i - 1) * drift, 0, 1) * 255),
                    0, 255).astype(np.uint8)
            for i in frame_ids
        ]


def make_batch_iterator(
    dataset,
    batch_size: int,
    crop: int,
    n_frames: int = 3,
    seed: int = 0,
    flip: bool = True,
    workers: int = 0,
    prefetch: int = 0,
    raw_uint8: bool = False,
):
    """Infinite iterator of (B, n_frames, crop, crop, 3) batches —
    float32 in [0,1] by default, uint8 with ``raw_uint8=True`` (the train
    CLI uploads uint8 and converts on device: 4x less H2D traffic).

    Frame windows follow the reference: a random contiguous window of
    ``n_frames`` odd-strided frames from each septuplet, random spatial
    crop, random horizontal/vertical flip, random temporal reversal.

    Host parallelism (the reference's ``DataLoader(num_workers=4)``): all
    random decisions are *planned*
    sequentially from one generator, so the sample stream is identical for
    any worker count; only PNG decode + crop is fanned out.

    Args:
      workers: decode threads per batch (0 = synchronous).
      prefetch: batches prepared ahead by a background thread (0 = none).
    """
    rng = np.random.default_rng(seed)

    def plan_one():
        """Draw every random decision (fixed order, single stream)."""
        idx = int(rng.integers(len(dataset)))
        # window: for 3 frames pick stride in {1, 2, 3}; for 5 frames
        # contiguous (1..5, 2..6, 3..7).
        if n_frames == 3:
            stride = int(rng.integers(1, 4))
            start = int(rng.integers(1, 8 - 2 * stride))
            ids = [start, start + stride, start + 2 * stride]
        else:
            start = int(rng.integers(1, 9 - n_frames))
            ids = list(range(start, start + n_frames))
        if flip and rng.random() < 0.5:
            ids = ids[::-1]
        # Crop offsets as unit draws: mapped to pixels once (h, w) is known.
        u_y, u_x = float(rng.random()), float(rng.random())
        flip_h = flip and rng.random() < 0.5
        flip_v = flip and rng.random() < 0.5
        return idx, ids, u_y, u_x, flip_h, flip_v

    def materialize(plan):
        idx, ids, u_y, u_x, flip_h, flip_v = plan
        frames = dataset.load(idx, ids)
        h, w, _ = frames[0].shape
        y0 = int(u_y * (max(h - crop, 0) + 1))
        x0 = int(u_x * (max(w - crop, 0) + 1))
        frames = [f[y0 : y0 + crop, x0 : x0 + crop] for f in frames]
        if flip_h:
            frames = [f[:, ::-1] for f in frames]
        if flip_v:
            frames = [f[::-1] for f in frames]
        return np.stack(frames)

    pool = None
    if workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=workers)

    def next_batch():
        plans = [plan_one() for _ in range(batch_size)]
        mats = pool.map(materialize, plans) if pool else map(
            materialize, plans
        )
        out = np.stack(list(mats))
        return out if raw_uint8 else to_float(out)

    if prefetch <= 0:
        while True:
            yield next_batch()
    else:
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=prefetch)

        def fill():
            while True:
                q.put(next_batch())

        threading.Thread(target=fill, daemon=True).start()
        while True:
            yield q.get()
