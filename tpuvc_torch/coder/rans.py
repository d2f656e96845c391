"""ctypes bindings for the native rANS coder.

API mirrors the reference's coder boundary (compressai.ans
encode_with_indexes / decode_with_indexes): flat int32 symbol/index arrays
against per-index quantized CDF tables. The C calls release the GIL, so
per-frame streams code concurrently on threads (tpuvc_torch.coder.parallel).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from tpuvc_torch import obs
from tpuvc_torch.coder.build import lib_path

_lib = None
_LOCK = threading.Lock()


def _get_lib():
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(lib_path())
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.tpuvc_torch_rans_encode.restype = ctypes.c_int
            lib.tpuvc_torch_rans_encode.argtypes = [
                i32p, i32p, ctypes.c_int,
                i32p, ctypes.c_int, ctypes.c_int, i32p, i32p,
                u8p, ctypes.c_int,
            ]
            lib.tpuvc_torch_rans_decode.restype = ctypes.c_int
            lib.tpuvc_torch_rans_decode.argtypes = [
                u8p, ctypes.c_int, i32p, ctypes.c_int,
                i32p, ctypes.c_int, ctypes.c_int, i32p, i32p,
                i32p,
            ]
            lib.tpuvc_torch_rans_decode_batch.restype = ctypes.c_int
            lib.tpuvc_torch_rans_decode_batch.argtypes = [
                ctypes.POINTER(u8p), i32p, ctypes.c_int, u8p, ctypes.c_int,
                i32p, ctypes.c_int, ctypes.c_int, i32p, i32p,
                ctypes.POINTER(ctypes.c_int16),
            ]
            lib.tpuvc_torch_pmf_to_quantized_cdf.restype = ctypes.c_int
            lib.tpuvc_torch_pmf_to_quantized_cdf.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int, i32p,
            ]
            _lib = lib
    return _lib


def build() -> None:
    """Compile (or load the cached) rANS library now."""
    _get_lib()


def pmf_to_quantized_cdf_native(pmf, precision: int = 16) -> np.ndarray:
    """C++ pmf -> quantized CDF; equal to
    tpuvc_torch.entropy.cdf.pmf_to_quantized_cdf (tests hold the match)."""
    pmf = np.ascontiguousarray(pmf, dtype=np.float64)
    out = np.empty(pmf.size + 1, dtype=np.int32)
    rc = _get_lib().tpuvc_torch_pmf_to_quantized_cdf(
        pmf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pmf.size, precision, _i32p(out),
    )
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed (code {rc})")
    return out


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


@obs.spanned("entropy.rans")
def encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets) -> bytes:
    """Encode int symbols to a byte stream.

    Args:
      symbols, indexes: int arrays of equal size N; symbol i is coded with
        CDF row indexes[i].
      cdfs: (ncdfs, stride) int32 quantized CDFs (row r valid through
        cdf_lengths[r]; escape slot at cdf_lengths[r]-2).
      cdf_lengths, offsets: (ncdfs,) int32.
    """
    symbols = _as_i32(symbols).ravel()
    indexes = _as_i32(indexes).ravel()
    if symbols.shape != indexes.shape:
        raise ValueError(f"{symbols.shape} symbols vs {indexes.shape} indexes")
    cdfs = _as_i32(cdfs)
    cdf_lengths = _as_i32(cdf_lengths)
    offsets = _as_i32(offsets)
    n = symbols.size
    lib = _get_lib()
    capacity = max(1024, n * 8 + 64)
    while True:
        out = np.empty(capacity, dtype=np.uint8)
        nbytes = lib.tpuvc_torch_rans_encode(
            _i32p(symbols), _i32p(indexes), n,
            _i32p(cdfs), cdfs.shape[0], cdfs.shape[1],
            _i32p(cdf_lengths), _i32p(offsets),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), capacity,
        )
        if nbytes == -1:
            capacity *= 2
            continue
        if nbytes < 0:
            raise ValueError(f"rANS encode failed (code {nbytes})")
        obs.count("entropy.rans_bytes", nbytes)
        return bytes(out[:nbytes])


@obs.spanned("entropy.rans")
def decode_with_indexes(stream: bytes, indexes, cdfs, cdf_lengths, offsets) -> np.ndarray:
    """Decode N symbols (N = indexes.size) from a byte stream."""
    indexes = _as_i32(indexes).ravel()
    cdfs = _as_i32(cdfs)
    cdf_lengths = _as_i32(cdf_lengths)
    offsets = _as_i32(offsets)
    n = indexes.size
    buf = np.frombuffer(stream, dtype=np.uint8)
    out = np.empty(n, dtype=np.int32)
    rc = _get_lib().tpuvc_torch_rans_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        _i32p(indexes), n,
        _i32p(cdfs), cdfs.shape[0], cdfs.shape[1],
        _i32p(cdf_lengths), _i32p(offsets),
        _i32p(out),
    )
    if rc != 0:
        raise ValueError(f"rANS decode failed (code {rc})")
    obs.count("entropy.rans_bytes", buf.size)
    return out


@obs.spanned("entropy.rans")
def decode_batch(streams, indexes, cdfs, cdf_lengths, offsets, out) -> np.ndarray:
    """Decode ``len(streams)`` independent streams in one native call, one
    thread a stream: stream k's symbols against the uint8 CDF row indexes
    ``indexes[k]``, written into ``out[k]`` as int16 (the symbols' device
    width; a wider value wraps, as ``astype(np.int16)`` would). ``indexes``
    and ``out`` are C-contiguous with ``len(streams)`` rows of equal size.
    Returns ``out``."""
    k = len(streams)
    if not (isinstance(indexes, np.ndarray) and indexes.dtype == np.uint8
            and indexes.flags.c_contiguous and len(indexes) == k):
        raise ValueError(f"indexes: a C-contiguous uint8 array of {k} rows")
    if not (isinstance(out, np.ndarray) and out.dtype == np.int16 and out.flags.c_contiguous
            and out.shape == indexes.shape and out.flags.writeable):
        raise ValueError(f"out: a writable C-contiguous int16 array of shape {indexes.shape}")
    cdfs = _as_i32(cdfs)
    cdf_lengths = _as_i32(cdf_lengths)
    offsets = _as_i32(offsets)
    bufs = [np.frombuffer(st, dtype=np.uint8) for st in streams]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (u8p * k)(*(b.ctypes.data_as(u8p) for b in bufs))
    nbytes = np.array([b.size for b in bufs], dtype=np.int32)
    rc = _get_lib().tpuvc_torch_rans_decode_batch(
        ptrs, _i32p(nbytes), k, indexes.ctypes.data_as(u8p), indexes.size // max(k, 1),
        _i32p(cdfs), cdfs.shape[0], cdfs.shape[1],
        _i32p(cdf_lengths), _i32p(offsets),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    if rc != 0:
        raise ValueError(f"rANS decode failed (code {rc})")
    obs.count("entropy.rans_bytes", int(nbytes.sum()))
    return out
