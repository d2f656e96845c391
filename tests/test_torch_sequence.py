"""The port's whole-sequence path against tpuvc on the CPU: the sequence
schedule, the decoded picture buffer, the VSequenceBitstream byte layout,
PSNR, synthetic frames and PNG writing, and round trips of the port's
encode_v/decode_v, encode_b/decode_b and encode_p/decode_p CLIs
(``--device cpu``).

The CLI runs use tpuvc's tests/test_vseq_cli.py model sizes (LHBDC and
Flex-Rate N=32, ELIC N=16 M=24 groups (4, 4, 16)) on 9 synthetic 64x64
frames at GOP 4; FlowGuidedB and DeformB run at their full width, as
tpuvc's CLI builds them. Their zero-initialised heads (v4's flow and
offset heads, v3's offset heads, Flex-Rate's flow refinement) are seeded
(``chip_smoke.cli_heads_seeded``). Each decode must equal the encoder's
reconstructions bit for bit (``torch.equal``). The low-delay CLIs code
5 synthetic 128x128 frames (I P P P I) with DMC at tpuvc's test size
(feat 16, N 32), so the fractional ratios really down-sample.
"""

import contextlib
import io
import json
import os
import re
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_params_common import write_dmc_checkpoints, write_sequence_checkpoints
from tpuvc.coder import container as jcont
from tpuvc.data import uvg as juvg
from tpuvc.eval import metrics as jmet
from tpuvc.gop import dpb as jdpb
from tpuvc.gop import order as jorder
from tpuvc_torch.coder import container as tcont
from tpuvc_torch.coder import parallel
from tpuvc_torch.data import uvg as tuvg
from tpuvc_torch.data.frames import save_png
from tpuvc_torch.eval import metrics as tmet
from tpuvc_torch.gop import dpb as tdpb
from tpuvc_torch.gop import order as torder

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _pools():
    yield
    parallel.shutdown()


@pytest.mark.parametrize("gop", [4, 8, 16])
@pytest.mark.parametrize("n", [9, 17, 33, 300, 600])
def test_sequence_schedule_matches_tpuvc(gop, n):
    assert torder.sequence_schedule(gop, n) == jorder.sequence_schedule(gop, n)


def test_dpb_selects_the_same_references():
    """A seeded walk of adds (with FIFO eviction at capacity 8) and
    selections: both buffers pick the same frames and display orders."""
    rng = np.random.default_rng(0)
    a, b = tdpb.DecodedPictureBuffer(capacity=8), jdpb.DecodedPictureBuffer(capacity=8)
    for step in range(200):
        order = int(rng.integers(0, 64))
        if step % 3 == 0 or not len(a):
            a.add(f"f{order}", order)
            b.add(f"f{order}", order)
        else:
            assert a.select_references(order) == b.select_references(order)
    order, typ = torder.sequence_schedule(16, 33)
    a, b = tdpb.DecodedPictureBuffer(), jdpb.DecodedPictureBuffer()
    for idx in order:
        if typ[idx] == "B":
            assert a.select_references(idx) == b.select_references(idx)
        a.add(idx, idx)
        b.add(idx, idx)


FIELDS = dict(family="flowguided_b", width=1920, height=1080, gop=16, n_frames=3,
              frames=[("I", 0, b"intra"), ("I", 16, b""), ("B", 8, b"b" * 300)],
              mode=1, max_batch=4, dtype=1, window_gops=2, mesh=1)


def test_vsequence_bytes_match_tpuvc_both_ways():
    port = tcont.VSequenceBitstream(**FIELDS)
    ref = jcont.VSequenceBitstream(**FIELDS)
    blob = port.serialize()
    assert blob == ref.serialize()
    assert len(blob) == port.num_bytes == ref.num_bytes
    assert jcont.VSequenceBitstream.deserialize(blob) == ref
    assert tcont.VSequenceBitstream.deserialize(ref.serialize()) == port
    assert tcont.B_FAMILY_IDS == jcont.B_FAMILY_IDS
    assert tcont.B_FAMILY_NAMES == jcont.B_FAMILY_NAMES


def test_vsequence_parses_tpv2_and_rejects_bad_streams():
    blob = tcont.VSequenceBitstream(**FIELDS).serialize()
    hsize = struct.calcsize(tcont.VSequenceBitstream.HEADER)
    tpv2 = b"TPV2" + blob[4 : hsize - 1] + blob[hsize:]  # no mesh byte
    parsed = tcont.VSequenceBitstream.deserialize(tpv2)
    assert vars(parsed) == vars(jcont.VSequenceBitstream.deserialize(tpv2))
    assert parsed.mesh == 1 and parsed.frames == FIELDS["frames"]
    for bad, match in (
        (blob[: hsize + 3], "record 0/3 header past EOF"),
        (blob[:-1], "frame 8 blob past EOF"),
        (blob + b"\0", "1 trailing bytes"),
        (b"TPV1" + blob[4:], "TPV1"),
        (b"XXXX" + blob[4:], "bad sequence magic"),
    ):
        with pytest.raises(ValueError, match=match):
            tcont.VSequenceBitstream.deserialize(bad)
        with pytest.raises(ValueError, match=match):
            jcont.VSequenceBitstream.deserialize(bad)
    with pytest.raises(ValueError, match="uint8"):
        tcont.VSequenceBitstream(**{**FIELDS, "mesh": 256}).serialize()


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_psnr_matches_tpuvc(kind):
    rng = np.random.default_rng(1)
    ref = rng.random((64, 48, 3), dtype=np.float32)
    dec = np.clip(ref + 0.05 * rng.standard_normal(ref.shape).astype(np.float32), -0.1, 1.1)
    if kind == "uint8":
        ref, dec = (np.clip(np.rint(a * 255), 0, 255).astype(np.uint8) for a in (ref, dec))
    assert tmet.psnr_uint8_np(ref, dec) == jmet.psnr_uint8_np(ref, dec)
    # float32 means of the same squared errors, summed in other orders
    np.testing.assert_allclose(float(tmet.psnr_uint8(torch.from_numpy(ref), torch.from_numpy(dec))),
                               float(jmet.psnr_uint8(jnp.asarray(ref), jnp.asarray(dec))),
                               rtol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64), (50, 70), (130, 97)])
def test_synthetic_sequence_matches_tpuvc(hw):
    t = tuvg.SyntheticSequence(n_frames=5, h=hw[0], w=hw[1], seed=3)
    j = juvg.SyntheticSequence(n_frames=5, h=hw[0], w=hw[1], seed=3)
    assert len(t) == len(j) and t.size == j.size
    for i in range(5):
        assert np.array_equal(t.u8(i), j.u8(i))
        assert np.array_equal(t[i], j[i])
        x = tuvg.device_frame(t.u8(i), "cpu")
        assert torch.equal(x, torch.from_numpy(j[i]))


def test_save_png_reads_back_through_pil(tmp_path):
    from PIL import Image

    img = np.random.default_rng(2).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    save_png(str(path), img)
    assert np.array_equal(np.asarray(Image.open(path).convert("RGB")), img)
    assert np.array_equal(tuvg.SequenceFrames(str(tmp_path)).u8(0)[0, :37, :53], img)


SMALL = [
    "--synthetic", "9", "--width", "64", "--height", "64", "--gop", "4",
    "--init", "random", "--N", "32",
    "--intra_N", "16", "--intra_M", "24", "--intra_groups", "4,4,16",
    "--device", "cpu",
]
MODEL_ARGS = SMALL[SMALL.index("--init"):]


def _round_trip(tmp_path, enc_args, dec_args):
    from tpuvc_torch.cli import decode_v, encode_v

    bin_path = str(tmp_path / "seq.tpvb")
    out_dir = str(tmp_path / "dec")
    enc = encode_v.main(enc_args + ["--bin", bin_path])
    dec = decode_v.main(dec_args + ["--bin", bin_path, "--out_dir", out_dir, "--synthetic", "9"])
    assert sorted(enc) == sorted(dec) == list(range(9))
    for i in range(9):
        assert enc[i].shape == (64, 64, 3)
        assert torch.equal(enc[i], dec[i]), i
    assert sorted(os.listdir(out_dir)) == [f"frame_{i:05d}.png" for i in range(9)]
    with open(bin_path, "rb") as f:
        blob = f.read()
    port, ref = tcont.VSequenceBitstream.deserialize(blob), jcont.VSequenceBitstream.deserialize(blob)
    assert ref == jcont.VSequenceBitstream(**vars(port))
    assert sorted(i for _, i, _ in ref.frames) == list(range(9))
    assert [i for t, i, _ in ref.frames if t == "I"] == [0, 4, 8]
    return port


CLI_CASES = {
    "lhbdc_sequential": ["--family", "lhbdc"],
    "lhbdc_level_batched_bf16": ["--family", "lhbdc", "--level_batched", "--window_gops",
                                 "2", "--max_batch", "4", "--compute_dtype", "bfloat16"],
    "flowguided_b_level_batched": ["--family", "flowguided_b", "--level_batched",
                                   "--s", "1.0"],
    # 2-GOP windows at batch 1: two one-frame chunks at level 0 and four at
    # level 1, which the decoder decodes two at a time
    "flowguided_b_level_batched_paired": ["--family", "flowguided_b", "--level_batched",
                                          "--window_gops", "2", "--max_batch", "1",
                                          "--s", "1.0"],
    "deform_b_sequential": ["--family", "deform_b", "--s", "1.5"],
    "deform_b_level_batched_bf16": ["--family", "deform_b", "--level_batched", "--window_gops",
                                    "2", "--max_batch", "2", "--compute_dtype", "bfloat16",
                                    "--s", "1.0"],
    "flexrate_sequential": ["--family", "flexrate", "--n", "1", "--interp", "0.66"],
    "flexrate_level_batched_bf16": ["--family", "flexrate", "--level_batched", "--window_gops",
                                    "2", "--max_batch", "4", "--compute_dtype", "bfloat16",
                                    "--n", "2", "--interp", "1.0"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_round_trip_is_bit_exact(tmp_path, case):
    extra = CLI_CASES[case]
    spread = {}
    trace = tmp_path / "decode_trace.json"
    dec_args = MODEL_ARGS + (["--trace", str(trace)] if case.endswith("_paired") else [])
    with chip_smoke.cli_heads_seeded(spread):
        seq = _round_trip(tmp_path, SMALL + extra, dec_args)
    if case.endswith("_paired"):
        counters = json.loads(trace.read_text())["counters"]
        assert counters["decode.paired_chunks"] > 0, counters
    if seq.family in chip_smoke.SEEDED_FAMILIES:
        # seeded heads: fractional flows and offsets in both passes
        chip_smoke.check_spread(spread, case, seq.family)
    assert seq.family == extra[1]
    assert (seq.width, seq.height, seq.gop, seq.n_frames) == (64, 64, 4, 9)
    assert seq.mode == (1 if "--level_batched" in extra else 0)
    assert seq.dtype == (1 if "bfloat16" in extra else 0)
    if "--window_gops" in extra:
        assert (seq.window_gops, seq.max_batch) == (2, int(extra[extra.index("--max_batch") + 1]))
        # The window's three anchors are one batch of I records.
        assert [t for t, _, _ in seq.frames[:4]] == ["I", "I", "I", "B"]


def test_cli_loads_tpuvc_checkpoints(tmp_path):
    """--init load reads what tpuvc's save_checkpoint writes (LHBDC and
    ELIC), converts it, and codes a bit-exact round trip."""
    from tpuvc_torch.cli import encode_b

    wdir = tmp_path / "weights"
    wdir.mkdir()
    lhbdc, _ = write_sequence_checkpoints(wdir)
    load = ["--init", "load", "--weights", str(wdir), "--weights_intra",
            str(wdir / "elic.msgpack"), "--l", "845"]
    args = [a for a in SMALL if a not in ("--init", "random")] + load
    model = encode_b.load_model(encode_b.build_parser().parse_args(
        ["--init", "load", "--weights", str(wdir), "--l", "845", "--N", "32"]))
    w = lhbdc["params"]["mv_compressor"]["g_a_layers_6"]["kernel"]
    assert np.array_equal(model.mv_compressor.g_a_layers[6].weight.detach().numpy(),
                          np.asarray(w).transpose(3, 2, 0, 1))
    _round_trip(tmp_path, args + ["--level_batched", "--max_batch", "2"],
                [a for a in MODEL_ARGS if a not in ("--init", "random")] + load)


def test_encode_decode_b_round_trip_on_real_frames(tmp_path):
    from tpuvc_torch.cli import decode_b, encode_b
    from tpuvc_torch.data.frames import float_to_uint8, load_png

    r1, cur, r2 = (os.path.join(ROOT, "frames", f) for f in ("ref_1.png", "current.png",
                                                            "ref_2.png"))
    bin_path, out_path = str(tmp_path / "bits.bin"), str(tmp_path / "dec.png")
    common = ["--family", "lhbdc", "--init", "random", "--N", "32", "--device", "cpu",
              "--compute_dtype", "bfloat16"]
    bits, recon = encode_b.main(common + ["--ref_1", r1, "--ref_2", r2, "--current", cur,
                                          "--bin", bin_path, "--l", "845"])
    assert os.path.getsize(bin_path) == bits.num_bytes
    x_hat = decode_b.main(common + ["--ref_1", r1, "--ref_2", r2, "--bin", bin_path,
                                    "--out", out_path, "--current", cur])
    assert torch.equal(x_hat, recon)
    img = load_png(out_path)
    assert img.shape == load_png(cur).shape == (192, 256, 3)
    assert np.array_equal(img, float_to_uint8(recon[0, :192, :256].numpy()))
    assert jcont.BFrameBitstream.deserialize(open(bin_path, "rb").read()).rate_id == 845


@pytest.mark.parametrize("family, rate, model", [
    ("deform_b", ["--s", "1.5"], []),
    ("flexrate", ["--n", "2", "--interp", "0.33"], ["--N", "32"]),
])
def test_encode_decode_b_v3_and_flexrate_round_trip(tmp_path, family, rate, model):
    """encode_b / decode_b on the real frames (192x256) for DeformB (full
    width) and Flex-Rate, their heads seeded in both: the decode equals the
    encoder's reconstruction and the header carries the rate."""
    from tpuvc_torch.cli import decode_b, encode_b

    r1, cur, r2 = (os.path.join(ROOT, "frames", f) for f in ("ref_1.png", "current.png",
                                                            "ref_2.png"))
    bin_path, out_path = str(tmp_path / "bits.bin"), str(tmp_path / "dec.png")
    common = ["--family", family, "--init", "random", "--device", "cpu"] + model
    with chip_smoke.cli_heads_seeded():
        bits, recon = encode_b.main(common + rate + [
            "--ref_1", r1, "--ref_2", r2, "--current", cur, "--bin", bin_path])
        x_hat = decode_b.main(common + ["--ref_1", r1, "--ref_2", r2, "--bin", bin_path,
                                        "--out", out_path])
    assert torch.equal(x_hat, recon)
    blob = open(bin_path, "rb").read()
    if family == "flexrate":
        assert jcont.BFrameBitstream.deserialize(blob).rate_id == 200330
    else:
        assert jcont.VFrameBitstream.deserialize(blob).s_milli == 1500


P_SMALL = [
    "--synthetic", "5", "--width", "128", "--height", "128", "--intra_period", "4",
    "--init", "random", "--feat", "16", "--N", "32",
    "--intra_N", "16", "--intra_M", "24", "--intra_groups", "4,4,16", "--device", "cpu",
]
P_MODEL_ARGS = P_SMALL[P_SMALL.index("--init"):]
P_CASES = {
    "fixed_ratio": ["--ratio", "1.5", "--q", "1.25"],
    "adaptive": ["--adaptive", "--ratios", "1.0,1.25,1.5,2.0"],
}


@pytest.mark.parametrize("case", list(P_CASES))
def test_encode_decode_p_round_trip_is_bit_exact(tmp_path, case):
    """encode_p then decode_p: every decoded frame equals the encoder's
    reconstruction, in tpuvc's PSequenceBitstream / PFrameBitstream layout,
    each P-frame's header carrying the ratio coded (with --adaptive: the
    one the search printed)."""
    from tpuvc_torch.cli import decode_p, encode_p

    bin_path, out_dir = str(tmp_path / "seq.tpvs"), str(tmp_path / "dec")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        enc = encode_p.main(P_SMALL + P_CASES[case] + ["--bin", bin_path])
    dec = decode_p.main(P_MODEL_ARGS + ["--bin", bin_path, "--out_dir", out_dir,
                                        "--synthetic", "5"])
    assert sorted(enc) == sorted(dec) == list(range(5))
    for i in range(5):
        assert enc[i].shape == (128, 128, 3)
        assert torch.equal(enc[i], dec[i]), i
    assert sorted(os.listdir(out_dir)) == [f"frame_{i:05d}.png" for i in range(5)]
    seq = jcont.PSequenceBitstream.deserialize(open(bin_path, "rb").read())
    assert (seq.width, seq.height) == (128, 128)
    assert [t for t, _ in seq.frames] == ["I", "P", "P", "P", "I"]
    ratios = [jcont.PFrameBitstream.deserialize(b).ratio_centi for t, b in seq.frames if t == "P"]
    printed = [round(100 * float(r)) for r in
               re.findall(r"^frame +\d+ P ratio ([0-9.]+)$", log.getvalue(), flags=re.M)]
    assert ratios == printed
    if case == "fixed_ratio":
        assert ratios == [150] * 3
    else:
        assert set(ratios) <= {100, 125, 150, 200}


def test_encode_p_loads_tpuvc_checkpoints(tmp_path):
    """--init load reads tpuvc's DMC and ELIC msgpack checkpoints."""
    from tpuvc_torch.cli import encode_p

    wdir = tmp_path / "weights"
    wdir.mkdir()
    trees = write_dmc_checkpoints(wdir)
    args = encode_p.build_parser().parse_args(
        ["--init", "load", "--feat", "16", "--N", "32", "--intra_N", "16", "--intra_M", "24",
         "--intra_groups", "4,4,16", "--weights_dmc", str(wdir / "dmc.msgpack"),
         "--weights_intra", str(wdir / "elic.msgpack")])
    intra, p_coder = encode_p.build_codecs(args, torch.device("cpu"))
    p_coder.close()
    w = trees["dmc"]["params"]["y_coder"]["adaptors_2"]["kernel"]
    assert np.array_equal(p_coder.model.y_coder.adaptors[2].weight.detach().numpy(),
                          np.asarray(w).transpose(3, 2, 0, 1))
    assert np.array_equal(p_coder.model.mv_coder.inv_gain.detach().numpy(),
                          trees["dmc"]["params"]["mv_coder"]["inv_gain"])


@pytest.mark.parametrize("argv, match", [
    (["--family", "flowguided_b", "--adaptive", "--level_batched"], "sequential mode"),
    (["--level_batched", "--mesh", "2"], "WORLD_SIZE"),
])
def test_unported_options_exit_with_their_roadmap_item(tmp_path, argv, match):
    from tpuvc_torch.cli import encode_v

    with pytest.raises(SystemExit, match=match):
        encode_v.main(SMALL + argv + ["--bin", str(tmp_path / "x.tpvb")])


def test_clis_default_to_cuda_without_fallback(tmp_path):
    from tpuvc_torch.cli import decode_v, encode_b, encode_v

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    argv = [a for a in SMALL if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_v.main(argv + ["--bin", str(tmp_path / "x.tpvb")])
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_v.main(["--bin", str(tmp_path / "x.tpvb")])
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_b.main(["--init", "random"])
    from tpuvc_torch.cli import decode_p, encode_p

    argv = [a for a in P_SMALL if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_p.main(argv + ["--bin", str(tmp_path / "x.tpvs")])
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_p.main(["--bin", str(tmp_path / "x.tpvs")])
