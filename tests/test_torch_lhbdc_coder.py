"""The port's own real-bitstream coding on the CPU: encode -> streams ->
decode must reproduce the encoder's reconstruction bit for bit, single-frame
and level-batched, in float32 and under the bfloat16 policy, over a small
hierarchical GOP walk shaped like bench.py's window. The streams use tpuvc's
container layout, so tpuvc.coder.container parses them.
"""

import numpy as np
import pytest
import torch

from tpuvc.coder.container import BFrameBitstream as JBFrame
from tpuvc_torch.coder import parallel
from tpuvc_torch.coder.container import BFrameBitstream
from tpuvc_torch.models.hyperprior import HyperpriorCoder, ResidualCompressor
from tpuvc_torch.models.layers import init_weights
from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder
from tpuvc_torch.ops.precision import policy_from_name

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def coder():
    model = LHBDC(N=16, generator=torch.Generator().manual_seed(0))
    yield LHBDCCoder(model, device="cpu")
    parallel.shutdown()


def _frames(n, shape=(64, 64, 3), seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random(shape, dtype=np.float32)
    drift = 0.03 * rng.standard_normal(shape).astype(np.float32)
    return [torch.from_numpy(np.clip(base + i * drift, 0, 1))[None] for i in range(n)]


def _reparse(bits):
    blob = bits.serialize()
    assert JBFrame.deserialize(blob).serialize() == blob  # tpuvc reads it
    return BFrameBitstream.deserialize(blob)


def test_hyperprior_coder_round_trip():
    model = ResidualCompressor(N=16)
    init_weights(model, torch.Generator().manual_seed(1))
    hc = HyperpriorCoder(model.eval())
    x = torch.from_numpy(
        (0.3 * np.random.default_rng(2).standard_normal((2, 64, 64, 3))).astype(np.float32)
    )
    single = hc.compress(x)
    assert torch.equal(
        hc.decompress(single["strings"], single["shape"], batch=2),
        hc.synthesize(single["y_hat"]),
    )
    batch = hc.compress_batch_from(*hc.analyze_quantized(x))
    assert len(batch["strings"]) == 2
    assert torch.equal(hc.decompress_batch(batch["strings"], batch["shape"]), batch["y_hat"])
    parallel.shutdown()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_frame_round_trip(coder, dtype):
    xb, xc, xa = _frames(3, seed=3)
    with policy_from_name(dtype):
        bits, x_hat = coder.encode_recon(xb, xc, xa, rate_id=1626)
        dec = coder.decode(xb, xa, _reparse(bits))
        again = coder.encode(xb, xc, xa, rate_id=1626)
    assert torch.equal(dec, x_hat)
    assert bits.rate_id == 1626 and bits.num_bytes > bits.HEADER_BYTES
    assert again.serialize() == bits.serialize()  # deterministic encoder


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gop_window_level_batched_round_trip(coder, dtype):
    """chip_smoke.py's window (bench_torch.bench_window) at a small size: 2
    GOPs of GOP-4 at batch 2, encoded level by level with async host
    phases, then decoded with the streams submitted ahead of the
    reference-dependent device tails."""
    import bench_torch

    code_window, decode_window, slot, n_real = bench_torch.bench_window(
        torch, coder, h=64, w=64, gop=4, G=2, B=2
    )
    with policy_from_name(dtype):
        streams, recon = code_window()
        for f in streams:
            streams[f] = _reparse(streams[f])
        decoded = decode_window(streams)
    assert n_real == 6 and sorted(streams) == [1, 2, 3, 5, 6, 7]
    for f, x in recon.items():
        assert torch.equal(decoded[f], x), f
        assert torch.isfinite(x).all() and x.shape == slot[f].shape


def test_blocking_level_batch_variants(coder):
    xb, xc, xa = (torch.cat([f, f.flip(1)]) for f in _frames(3, seed=5))
    bits, x_hat = coder.encode_level_batch(xb, xc, xa, rate_id=7)
    assert len(bits) == 2
    assert torch.equal(coder.decode_level_batch(xb, xa, bits), x_hat)
