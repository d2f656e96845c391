"""The two B-frame coder bodies (tpuvc_torch.models.bframe_coder) on the CPU.

Both conditional families, FlowGuidedB (v4) and DeformB (v3), decode a
chunk stepwise, and decode_v pairs two chunks of one level where the coder
runs unsharded. The encoder hooks that the benchmark's planted faults
replace (LHBDC's ``_compensate`` and ``_res_front``, DeformB's
``_res_inputs``) run on both encode paths.

Small seeded models at 64x64: FlowGuidedB at feature channels (16, 32, 48),
DeformB at (8, 16, 24), both N=M=32, 3 levels, groups (4, 4, 8, 16); LHBDC
at N=16. Every decode must reproduce the encoder's reconstruction bit for
bit.
"""

import numpy as np
import pytest
import torch

from tpuvc.coder.container import VFrameBitstream as JVFrame
from tpuvc_torch.coder import parallel
from tpuvc_torch.coder.container import VFrameBitstream
from tpuvc_torch.models.deform_b import DeformBCoder
from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder
from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder
from tpuvc_torch.ops.precision import policy_from_name

torch.set_num_threads(1)

COND_FAMILIES = ("flowguided_b", "deform_b")
SMALL = dict(N=32, seed=5, levels=3, groups=(4, 4, 8, 16))


@pytest.fixture(scope="module")
def coder_of():
    """-> coder_of(family): the family's small coder, built once."""
    import chip_smoke

    build = {
        "flowguided_b": lambda: FlowGuidedBCoder(
            chip_smoke.v4_model(torch, feature_channels=(16, 32, 48), **SMALL), device="cpu"),
        "deform_b": lambda: DeformBCoder(
            chip_smoke.v3_model(torch, feature_channels=(8, 16, 24), **SMALL), device="cpu"),
        "lhbdc": lambda: LHBDCCoder(
            LHBDC(N=16, generator=torch.Generator().manual_seed(0)), device="cpu"),
    }
    coders = {}

    def get(family):
        if family not in coders:
            coders[family] = build[family]()
        return coders[family]

    yield get
    parallel.shutdown()


def _frames(shape=(2, 64, 64, 3), seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random(shape, dtype=np.float32)
    drift = 0.04 * rng.standard_normal(shape).astype(np.float32)
    return base, np.clip(base + 0.5 * drift, 0, 1), np.clip(base + drift, 0, 1)


def _geometry(family, scale1, scale2):
    """The temporal scales a v4 call takes after s; v3 takes none."""
    return (scale1, scale2) if family == "flowguided_b" else ()


def _reparse(bits):
    blob = bits.serialize()
    assert JVFrame.deserialize(blob).serialize() == blob  # tpuvc reads it
    return VFrameBitstream.deserialize(blob)


def _alternate(*steps):
    """Drive stepwise decodes strictly in turn (each resumed as soon as the
    other has yielded, whether its host work is done or not)."""
    out = [None] * len(steps)
    live = list(range(len(steps)))
    while live:
        for k in list(live):
            try:
                next(steps[k])
            except StopIteration as stop:
                out[k] = stop.value
                live.remove(k)
    return out


@pytest.mark.parametrize("family", COND_FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stepwise_decode_equals_the_blocking_decode(coder_of, family, dtype):
    """One chunk's stepwise decode, driven alone, is decode_level_batch bit
    for bit, after 2 * (1 + 2 * groups) host round trips."""
    coder = coder_of(family)
    x1, xc, x2 = (torch.from_numpy(a) for a in _frames(seed=6))
    with policy_from_name(dtype):
        bits, x_hat = coder.encode_level_batch(x1, x2, xc, 1.0, *_geometry(family, 0.5, 0.5))
        parsed = [_reparse(b) for b in bits]
        steps = coder.decode_level_batch_steps(x1, x2, parsed)
        yields = 0
        while True:
            try:
                next(steps).result()
                yields += 1
            except StopIteration as stop:
                stepped = stop.value
                break
        blocking = coder.decode_level_batch(x1, x2, parsed)
    assert yields == 2 * (1 + 2 * 4)
    assert torch.equal(stepped, blocking)
    assert torch.equal(stepped, x_hat)


@pytest.mark.parametrize("family", COND_FAMILIES)
@pytest.mark.parametrize("drive", ["run_steps", "alternate"])
def test_two_chunks_decoded_in_turn_equal_one_after_the_other(coder_of, family, drive):
    """Two chunks of one level, their stepwise decodes interleaved on one
    thread, give the frames of decoding them one after the other, which
    are the encoder's."""
    coder = coder_of(family)
    chunks = []
    with policy_from_name("bfloat16"):
        for seed in (7, 8):
            x1, xc, x2 = (torch.from_numpy(a) for a in _frames(seed=seed))
            bits, x_hat = coder.encode_level_batch(x1, x2, xc, 1.0,
                                                   *_geometry(family, 0.5, -0.5))
            chunks.append((x1, x2, [_reparse(b) for b in bits], x_hat))
        one_by_one = [coder.decode_level_batch(x1, x2, bs) for x1, x2, bs, _ in chunks]
        steps = [coder.decode_level_batch_steps(x1, x2, bs) for x1, x2, bs, _ in chunks]
        paired = (parallel.run_steps if drive == "run_steps" else _alternate)(*steps)
    for (_, _, _, x_hat), single, both in zip(chunks, one_by_one, paired):
        assert torch.equal(both, single)
        assert torch.equal(both, x_hat)


@pytest.fixture(scope="module")
def stream_of(coder_of, tmp_path_factory):
    """-> stream_of(family): a 9-frame GOP-4 sequence coded level-batched
    with the family's coder in 2-GOP windows at batch 1: two one-frame
    chunks at level 0 and four at level 1. -> (stream bytes, ELIC coder,
    the encoder's frames)."""
    from tpuvc_torch.cli import encode_v

    streams = {}

    def get(family):
        if family in streams:
            return streams[family]
        path = tmp_path_factory.mktemp(family) / "seq.tpvb"
        args = encode_v.build_parser().parse_args([
            "--family", family, "--level_batched", "--window_gops", "2",
            "--max_batch", "1", "--s", "1.0", "--synthetic", "9", "--width", "64",
            "--height", "64", "--gop", "4", "--init", "random", "--intra_N", "16",
            "--intra_M", "24", "--intra_groups", "4,4,16", "--device", "cpu",
            "--compute_dtype", "bfloat16", "--bin", str(path),
        ])
        intra = encode_v.build_intra(args, torch.device("cpu"))
        recons = encode_v._encode_level_batched(args, encode_v.load_frames(args),
                                                coder_of(family), intra, torch.device("cpu"))
        streams[family] = path.read_bytes(), intra, recons
        return streams[family]

    return get


class _WholeShard:
    """A one-rank level-batch sharder: every row is this rank's."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x, b=None):
        self.calls += 1
        return x

    def gather(self, x, b):
        return x


def _decode_stream(blob, coder, intra):
    """decode_v's level-batched decode of ``blob``, traced: -> (frames,
    counters)."""
    from tpuvc_torch import obs
    from tpuvc_torch.cli import decode_v
    from tpuvc_torch.coder.container import VSequenceBitstream

    seq = VSequenceBitstream.deserialize(blob)
    obs.reset()
    obs.enable()
    try:
        with policy_from_name("bfloat16"):
            decoded = decode_v._decode_level_batched(seq, coder, intra, VFrameBitstream)
        return {i: x[:64, :64] for i, x in decoded.items()}, obs.counters()
    finally:
        obs.disable()
        obs.reset()


@pytest.mark.parametrize("family", COND_FAMILIES)
@pytest.mark.parametrize("sharded", [False, True])
def test_level_batched_decode_pairs_unsharded_chunks(coder_of, stream_of, family, sharded):
    """decode_v pairs each chunk with the next of its window and level (here
    all six), and decodes them bit-exactly; with the coder sharded over a
    mesh it keeps the blocking decode, chunk by chunk, and pairs none."""
    coder = coder_of(family)
    blob, intra, recons = stream_of(family)
    shard = _WholeShard() if sharded else None
    coder.set_shard(shard)
    try:
        decoded, counters = _decode_stream(blob, coder, intra)
    finally:
        coder.set_shard(None)
    assert sorted(decoded) == sorted(recons) == list(range(9))
    for i, x in recons.items():
        assert torch.equal(decoded[i], x), i
    assert counters["decode.chunks"] == 6
    assert counters.get("decode.paired_chunks", 0) == (0 if sharded else 6)
    if sharded:
        assert shard.calls == 6 * 3  # each chunk's references and streams


#: The encoder hooks that the benchmark's planted faults replace, by family.
HOOKS = [("lhbdc", LHBDCCoder, "_compensate"), ("lhbdc", LHBDCCoder, "_res_front"),
         ("deform_b", DeformBCoder, "_res_inputs")]


@pytest.mark.parametrize("family,cls,hook", HOOKS, ids=[f"{f}.{h}" for f, _, h in HOOKS])
@pytest.mark.parametrize("path", ["encode_recon", "encode_level_batch_async"])
def test_encode_paths_call_the_planted_fault_hooks(coder_of, monkeypatch, family, cls, hook,
                                                   path):
    """A recording stand-in for the hook runs on the encode path, so a fault
    planted there reaches the stream."""
    coder = coder_of(family)
    inner = getattr(cls, hook)
    calls = []

    def recording(self, *a, **kw):
        calls.append(hook)
        return inner(self, *a, **kw)

    monkeypatch.setattr(cls, hook, recording)
    x1, xc, x2 = (torch.from_numpy(a) for a in _frames(shape=(1, 64, 64, 3), seed=9))
    # LHBDC takes the current frame between the references, v3 after them.
    frames, rate = ((x1, xc, x2), ()) if family == "lhbdc" else ((x1, x2, xc), (1.0,))
    out = getattr(coder, path)(*frames, *rate)
    if path == "encode_level_batch_async":
        out[0]()
    assert calls == [hook]
