"""Frame IO and preparation (port of tpuvc.data.frames).

Frames are float32 NHWC in [0, 1]. Padding happens once at ingest (bottom
and right reflection to x64), so every shape downstream divides by the
codecs' strides.

``save_png`` writes 8-bit RGB PNGs with ``zlib`` and ``struct`` alone: the
decoders write PNGs on machines that have no Pillow. ``load_png`` reads
through Pillow, imported when it is called.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from tpuvc_torch.ops.pad import pad_to_multiple


def load_png(path) -> np.ndarray:
    """(H, W, 3) uint8."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path, img_uint8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (no filtering,
    one zlib stream)."""
    img = np.ascontiguousarray(img_uint8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_png takes (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    # Each scanline starts with its filter type, 0 (none).
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def to_float(img_uint8: np.ndarray) -> np.ndarray:
    return img_uint8.astype(np.float32) / 255.0


def float_to_uint8(img) -> np.ndarray:
    """Clamp and round to uint8, as before PSNR."""
    return np.clip(np.rint(np.asarray(img) * 255.0), 0, 255).astype(np.uint8)


def prepare_frame(path, multiple: int = 64):
    """Load a PNG -> padded (1, H', W', 3) float32 CPU tensor and the
    original (H, W)."""
    img = torch.from_numpy(to_float(load_png(path))[None])
    return pad_to_multiple(img, multiple)
