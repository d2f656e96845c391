"""The traffic's frames, made from the seed on the device.

Each sequence is a smooth multi-scale texture panned by a fractional
displacement every frame, with patches of another texture moving across it
at their own fractional speeds: UVG-like motion, so flows and deform
offsets are nonzero and fractional. Every seed gets the same set of speeds
and patch counts, in another order and in other directions, so the seed
changes the content and not the amount of motion. Frames are uint8, as a
decoded source video's are; the program is handed only these frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .weights import stream_seed


class Sequence:
    """What the program reads of a sequence: ``len()``, ``.size`` (h, w)
    and ``.u8(i)``, a (1, H, W, 3) uint8 array."""

    def __init__(self, frames: np.ndarray):
        self.frames = frames
        self.size = frames.shape[2:4]
        self.log = None  # the frames read, while a tap listens

    def __len__(self):
        return len(self.frames)

    def u8(self, i: int) -> np.ndarray:
        if self.log is not None:
            self.log.append(i)
        return self.frames[i]


def _texture(gen, h: int, w: int, device, octaves=(256, 128, 64, 32, 16, 8)):
    """(1, 3, h, w) smooth noise in [0, 1]: bilinear-upsampled random grids,
    coarse octaves weighted more."""
    out = torch.zeros((1, 3, h, w), device=device)
    for o in octaves:
        grid = torch.randn((1, 3, h // o + 2, w // o + 2), generator=gen, device=device)
        out += math.sqrt(o) * F.interpolate(grid, size=(h, w), mode="bilinear",
                                            align_corners=False)
    out = out / out.std()
    return torch.sigmoid(1.5 * out)


def _sample(tex, ys, xs):
    """``tex`` (1, C, Ht, Wt) at pixel positions (ys (H,), xs (W,)) plus a
    per-frame shift, bilinear; zeros outside. -> (T, C, H, W) for the
    (T, 2) shifts folded into ys/xs by the caller as (T, H) and (T, W)."""
    T = ys.shape[0]
    Ht, Wt = tex.shape[-2:]
    gy = ys * (2.0 / (Ht - 1)) - 1.0
    gx = xs * (2.0 / (Wt - 1)) - 1.0
    grid = torch.stack(torch.broadcast_tensors(gx[:, None, :], gy[:, :, None]), dim=-1)
    return F.grid_sample(tex.expand(T, -1, -1, -1), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def _motion(rng, n_seq: int, mix: dict) -> list[dict]:
    """Per sequence: the pan velocity and the patches' sizes, starts and
    velocities. Speeds come from the mix's fixed lists, permuted."""
    pans = rng.permutation(np.resize(np.asarray(mix["pan_px"], float), n_seq))
    counts = rng.permutation(np.resize(np.asarray(mix["patch_counts"], int), n_seq))
    speeds = list(mix["patch_px"])
    plan = []
    for j in range(n_seq):
        a = rng.uniform(0, 2 * math.pi)
        patches = []
        for k in range(int(counts[j])):
            b = rng.uniform(0, 2 * math.pi)
            sp = speeds[(j + k) % len(speeds)]
            patches.append({
                "size": rng.uniform(*mix["patch_size"]),      # share of the frame height
                "start": rng.uniform(0.15, 0.85, size=2),     # (y, x) share of the frame
                "v": (sp * math.sin(b), sp * math.cos(b)),
            })
        plan.append({"v": (pans[j] * math.sin(a), pans[j] * math.cos(a)), "patches": patches})
    return plan


@torch.no_grad()
def make(mix: dict, seed: int, device, chunk: int = 11) -> list[Sequence]:
    """The mix's sequences of ``seed``: ``mix["sequences"]`` of
    ``mix["frames"]`` frames at ``mix["height"]`` x ``mix["width"]``."""
    n, H, W, n_seq = mix["frames"], mix["height"], mix["width"], mix["sequences"]
    rng = np.random.default_rng(seed % 2**63)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 15))
    plan = _motion(rng, n_seq, mix)
    reach = int(math.ceil(max(mix["pan_px"]) * n)) + 8
    out = []
    for p in plan:
        bg = _texture(gen, H + 2 * reach, W + 2 * reach, device)
        tiles = [_texture(gen, max(8, int(q["size"] * H)), max(8, int(q["size"] * H * 1.5)),
                          device, octaves=(32, 16, 8)) for q in p["patches"]]
        frames = np.empty((n, 1, H, W, 3), dtype=np.uint8)
        ys0 = torch.arange(H, device=device, dtype=torch.float32)
        xs0 = torch.arange(W, device=device, dtype=torch.float32)
        for t0 in range(0, n, chunk):
            t = torch.arange(t0, min(t0 + chunk, n), device=device, dtype=torch.float32)
            img = _sample(bg, reach + ys0 + p["v"][0] * t[:, None] - p["v"][0] * n / 2,
                          reach + xs0 + p["v"][1] * t[:, None] - p["v"][1] * n / 2)
            for q, tile in zip(p["patches"], tiles):
                th, tw = tile.shape[-2:]
                py = q["start"][0] * H + q["v"][0] * t[:, None] - th / 2
                px = q["start"][1] * W + q["v"][1] * t[:, None] - tw / 2
                ly, lx = ys0 - py, xs0 - px                       # (T, H), (T, W)
                patch = _sample(tile, ly, lx)
                # a soft ellipse inscribed in the tile
                ry = (ly - (th - 1) / 2) / (th / 2)
                rx = (lx - (tw - 1) / 2) / (tw / 2)
                r2 = ry[:, :, None] ** 2 + rx[:, None, :] ** 2
                alpha = torch.clamp(4.0 * (1.0 - r2), 0.0, 1.0)[:, None]
                img = img * (1 - alpha) + patch * alpha
            u8 = torch.round(torch.clamp(img, 0, 1) * 255).to(torch.uint8)
            frames[t0:t0 + len(t), 0] = u8.permute(0, 2, 3, 1).cpu().numpy()
        out.append(Sequence(frames))
    return out
