"""Reader and writer of tpuvc's checkpoints: flax-msgpack pytrees of numpy
arrays.

Pure Python (``struct`` + numpy): the port runs where neither ``msgpack``
nor ``flax`` is installed. It reads what ``flax.serialization.
msgpack_serialize`` writes for tpuvc's checkpoints — msgpack maps, arrays
and scalars, numpy arrays as extension type 1 (a packed ``(shape, dtype
name, bytes)`` triple) and numpy scalars as type 3 — and writes the bytes
tpuvc's ``save_checkpoint`` writes for the same tree. flax's other encodings
(complex numbers, arrays above 1 GiB split into chunks) do not occur in
these checkpoints and are neither decoded nor written.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {
            0xC0: lambda: None,
            0xC2: lambda: False,
            0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"),
            0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"),
            0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"),
            0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"),
            0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"),
            0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1),
            0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4),
            0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: str(self.take(self.unpack(">B")), "utf-8"),
            0xDA: lambda: str(self.take(self.unpack(">H")), "utf-8"),
            0xDB: lambda: str(self.take(self.unpack(">I")), "utf-8"),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in simple:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return simple[b]()

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    return np.frombuffer(buf, dtype=np.dtype(name)).copy().reshape(shape)


def unpackb(data: bytes):
    """Decode one msgpack object (flax's extension types included)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes after msgpack object")
    return out


def load_checkpoint(path: str):
    """A tpuvc checkpoint file -> nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def _sized(out: list, n: int, small: tuple[int, int] | None, codes: tuple) -> None:
    """A msgpack length header: the fix form (base, limit) where it fits,
    else the 8-, 16- or 32-bit form (a code of None skips that width)."""
    if small is not None and n < small[1]:
        out.append(struct.pack(">B", small[0] | n))
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: list, v: int) -> None:
    if -32 <= v < 128:  # positive and negative fixint
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = (("BHIQ", (0xCC, 0xCD, 0xCE, 0xCF)) if v >= 0
             else ("bhiq", (0xD0, 0xD1, 0xD2, 0xD3)))
    for fmt, code in zip(*forms):
        bits = 8 * struct.calcsize(fmt)
        if (v < 1 << bits) if v >= 0 else (v >= -(1 << (bits - 1))):
            out.append(struct.pack(">B" + fmt, code, v))
            return
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: list, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(struct.pack(">B", fixed[len(data)]))
    else:
        _sized(out, len(data), None, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code) + data)


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, bytes):
        _sized(out, len(obj), None, (0xC4, 0xC5, 0xC6))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _sized(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.nbytes > 1 << 30:
            raise ValueError(f"cannot write a {arr.dtype} array of {arr.nbytes} bytes")
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        _pack_ext(out, code, packb((arr.shape, arr.dtype.name, arr.tobytes("C"))))
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to msgpack")


def packb(obj) -> bytes:
    """Encode one object as msgpack, numpy arrays and scalars as flax's
    extension types (the inverse of :func:`unpackb`)."""
    out: list[bytes] = []
    _pack(out, obj)
    return b"".join(out)


def _as_tree(tree):
    """tpuvc's ``jax.tree.map(np.asarray, tree)``: every leaf a numpy array
    (tensors copied to the host), dicts in sorted key order."""
    if isinstance(tree, dict):
        return {k: _as_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tree(v) for v in tree)
    if hasattr(tree, "detach"):  # a torch tensor
        tree = tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, tree) -> None:
    """Write ``tree`` (nested dicts of arrays, tensors and numbers) as tpuvc's
    ``save_checkpoint`` does: the same bytes, and the file replaced
    atomically through a temporary name."""
    blob = packb(_as_tree(tree))
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
