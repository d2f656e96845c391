"""tpuvc_torch.coder: the port's own rANS library, container, thread pools
and GOP tables, against tpuvc's where tpuvc has the same thing.

rANS and containers are exact: the port keeps tpuvc's stream format, so the
two packages' coders and parsers read each other's bytes.
"""

import contextvars

import numpy as np
import pytest

from tpuvc.coder import container as jcontainer
from tpuvc.coder import rans as jrans
from tpuvc.gop import order as jorder
from tpuvc_torch.coder import container as tcontainer
from tpuvc_torch.coder import parallel, rans
from tpuvc_torch.entropy.gaussian import GaussianConditional
from tpuvc_torch.gop import order as torder


@pytest.fixture(scope="module")
def tables():
    return GaussianConditional().build_tables()


def _symbols(tables, n, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(tables.cdf_lengths), n).astype(np.int32)
    spread = (tables.cdf_lengths[idx] - 2) // 2
    sym = np.round(rng.standard_normal(n) * spread * 0.3).astype(np.int32)
    edge = [5000, -7000, 123456, -1, 0]  # escapes and in-range
    sym[: len(edge)] = edge[:n]
    return sym, idx


@pytest.mark.parametrize("n", [1, 5, 1000, 50000])
def test_rans_round_trip_and_tpuvc_streams(tables, n):
    sym, idx = _symbols(tables, n, seed=n)
    args = (tables.cdfs, tables.cdf_lengths, tables.offsets)
    stream = rans.encode_with_indexes(sym, idx, *args)
    np.testing.assert_array_equal(rans.decode_with_indexes(stream, idx, *args), sym)
    # Same format as tpuvc's coder, byte for byte, both ways.
    assert stream == jrans.encode_with_indexes(sym, idx, *args)
    np.testing.assert_array_equal(jrans.decode_with_indexes(stream, idx, *args), sym)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_rans_batch_decode_equals_each_stream_decoded(tables, k):
    """One native call decodes k streams, a thread each, into int16: the
    per-stream decodes cast as the coders cast them (escapes wrap alike)."""
    args = (tables.cdfs, tables.cdf_lengths, tables.offsets)
    pairs = [_symbols(tables, 4000, seed=10 + j) for j in range(k)]
    streams = [rans.encode_with_indexes(sym, idx, *args) for sym, idx in pairs]
    indexes = np.stack([idx for _, idx in pairs]).astype(np.uint8)
    out = np.zeros(indexes.shape, np.int16)
    assert rans.decode_batch(streams, indexes, *args, out) is out
    for j, (sym, idx) in enumerate(pairs):
        np.testing.assert_array_equal(out[j], sym.astype(np.int16))
        np.testing.assert_array_equal(
            out[j], rans.decode_with_indexes(streams[j], idx, *args).astype(np.int16))
    with pytest.raises(ValueError):
        rans.decode_batch(streams, indexes.astype(np.int32), *args, out)
    with pytest.raises(ValueError):
        rans.decode_batch(streams, indexes, *args, out[:, :-1])
    with pytest.raises(ValueError):
        rans.decode_batch([b"\x00\x01"] + streams[1:], indexes, *args, out)


def test_rans_rejects_bad_input(tables):
    args = (tables.cdfs, tables.cdf_lengths, tables.offsets)
    with pytest.raises(ValueError):
        rans.encode_with_indexes([1, 2], [0], *args)
    with pytest.raises(ValueError):
        rans.encode_with_indexes([1], [10_000], *args)
    with pytest.raises(ValueError):
        rans.decode_with_indexes(b"\x00\x01", [0], *args)


def test_container_layout_is_tpuvcs():
    bits = tcontainer.BFrameBitstream(
        rate_id=845, mv_shape=(5, 8), res_shape=(5, 8),
        mv_y=b"\x01\x02", mv_z=b"\x03", res_y=b"\x04\x05\x06", res_z=b"\x07",
    )
    blob = bits.serialize()
    assert len(blob) == bits.num_bytes
    ref = jcontainer.BFrameBitstream.deserialize(blob)
    assert ref.serialize() == blob
    assert (ref.rate_id, ref.mv_shape, ref.res_y) == (845, (5, 8), b"\x04\x05\x06")
    assert tcontainer.BFrameBitstream.deserialize(blob) == bits


_POLICY = contextvars.ContextVar("test_policy", default="f32")


def test_pools_carry_the_submitters_context():
    token = _POLICY.set("bf16")
    try:
        assert parallel.async_pool().submit(_POLICY.get).result(timeout=30) == "bf16"
        assert parallel.parallel_map(lambda _: _POLICY.get(), range(4)) == ["bf16"] * 4
    finally:
        _POLICY.reset(token)
        parallel.shutdown()
    assert parallel.async_pool().submit(_POLICY.get).result(timeout=30) == "f32"
    parallel.shutdown()


@pytest.mark.parametrize("gop", [4, 8, 16, 32])
def test_gop_tables_match_tpuvc(gop):
    t, j = torder.gop_coding_table(gop), jorder.gop_coding_table(gop)
    assert (t.order, t.refs, t.level) == (j.order, j.refs, j.level)
    assert t.frames_by_level() == j.frames_by_level()
