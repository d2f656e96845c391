"""The port's DMC real-bitstream coder (``PFrameDMCCoder``) and its
low-delay eval loops on the CPU.

- Coding round trips at tpuvc's tests/test_dmc_bitstream.py size (feat 16,
  N 32, 128x128 frames, seeded weights from a torch.Generator): every
  decode reproduces the encoder's reconstruction and DPB bit for bit, the
  pipelined ``decode_sequence`` equals folding ``decode`` frame by frame,
  the header carries q and the down ratio, and the streams' size stays
  within tpuvc's own ``test_stream_bits_close_to_likelihood_bits`` margin of
  the likelihood bits.
- ``eval_sequence_lowdelay`` / ``eval_pframe_sequence`` and the results
  writers against tpuvc's on the same per-frame values.
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvc.eval import pframe_runner as jpr
from tpuvc.eval import results_io as jio
from tpuvc.eval import runner as jrun
from tpuvc_torch.coder.container import PFrameBitstream
from tpuvc_torch.eval import pframe_runner as tpr
from tpuvc_torch.eval import results_io as tio
from tpuvc_torch.eval import runner as trun
from tpuvc_torch.models.dmc import PFrameDMC, PFrameDMCCoder

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def coder():
    model = PFrameDMC(feat=16, N=32, generator=torch.Generator().manual_seed(0))
    c = PFrameDMCCoder(model, device="cpu")
    yield c
    c.close()


def _frames(n=4, hw=128, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((1, hw, hw, 3), dtype=np.float32)
    drift = 0.03 * rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    return torch.from_numpy(np.clip(base + np.cumsum(drift, axis=0), 0, 1))


def _dpb(ref):
    return {"ref_frame": ref, "ref_feature": None, "ref_down_ratio": 1.0}


DPB_KEYS = ("ref_frame", "ref_feature", "ref_mv_feature", "ref_y", "ref_mv_y")


@pytest.mark.parametrize("ratio, q", [(1.0, 0.0), (1.5, 1.0), (1.25, 0.5)])
def test_round_trip_is_bit_exact(coder, ratio, q):
    xs = _frames(seed=1)
    dpb = _dpb(xs[0:1])
    bits, enc_dpb = coder.encode(xs[1:2], dpb, ratio=ratio, q=q)
    assert len(bits.streams) == 10  # mv parts 0-3, mv z, y parts 0-3, z
    assert (bits.q_milli, bits.ratio_centi) == (round(1000 * q), round(100 * ratio))
    parsed = PFrameBitstream.deserialize(bits.serialize())
    x_hat, dec_dpb = coder.decode(dpb, parsed)
    assert x_hat.shape == (1, 128, 128, 3) and bool(torch.isfinite(x_hat).all())
    assert torch.equal(torch.clamp(x_hat, 0, 1), enc_dpb["ref_frame"])
    for k in DPB_KEYS:
        assert torch.equal(dec_dpb[k], enc_dpb[k]), k
    assert dec_dpb["ref_down_ratio"] == enc_dpb["ref_down_ratio"] == ratio
    x_hat2, _ = coder.decode(dpb, parsed)
    assert torch.equal(x_hat, x_hat2)


def test_decode_sequence_equals_folded_decode(coder):
    """Three chained P-frames (ratios 1.0, 1.5, 1.5) from encode_async: the
    pipelined decode, the folded per-frame decode and the encoder agree bit
    for bit on every frame and on the final DPB."""
    xs = _frames(seed=2)
    dpb = _dpb(xs[0:1])
    enc_dpb, futs, recons = dpb, [], []
    for i, ratio in ((1, 1.0), (2, 1.5), (3, 1.5)):
        fut, enc_dpb = coder.encode_async(xs[i : i + 1], enc_dpb, ratio=ratio, q=0.0)
        futs.append(fut)
        recons.append(enc_dpb["ref_frame"])
    bits = [PFrameBitstream.deserialize(f.result().serialize()) for f in futs]
    xs_seq, seq_dpb = coder.decode_sequence(dpb, bits)
    folded, fold_dpb = [], dpb
    for b in bits:
        x_hat, fold_dpb = coder.decode(fold_dpb, b)
        folded.append(x_hat)
    assert [b.ratio_centi for b in bits] == [100, 150, 150]
    for a, b, r in zip(xs_seq, folded, recons):
        assert torch.equal(a, b)
        assert torch.equal(torch.clamp(a, 0, 1), r)
    for k in DPB_KEYS:
        assert torch.equal(seq_dpb[k], fold_dpb[k]) and torch.equal(seq_dpb[k], enc_dpb[k]), k


def test_decode_sequence_raises_a_chain_failure(coder):
    """A corrupt stream fails the decode instead of hanging it."""
    xs = _frames(n=2, seed=3)
    bits, _ = coder.encode(xs[1:2], _dpb(xs[0:1]))
    bad = PFrameBitstream(q_milli=bits.q_milli, ratio_centi=bits.ratio_centi,
                          z_shape=(bits.z_shape[0] + 1, bits.z_shape[1]), streams=bits.streams)
    with pytest.raises(Exception):
        coder.decode_sequence(_dpb(xs[0:1]), [bits, bad])


def test_stream_bits_close_to_likelihood_bits(coder):
    """tpuvc's margin: the streams within 15% (plus 64 bytes of flush) above
    and 30% below the likelihood bits of the dequantize forward."""
    xs = _frames(n=2, seed=4)
    dpb = _dpb(xs[0:1])
    bits, _ = coder.encode(xs[1:2], dpb, ratio=1.0, q=0.0)
    stream_bits = 8 * sum(len(s) for s in bits.streams)
    with torch.no_grad():
        lik_bits = float(coder.model(xs[1:2], dpb, 1.0, "dequantize")["bits"])
    assert lik_bits * 0.7 < stream_bits < lik_bits * 1.15 + 8 * 64


def test_coder_defaults_to_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        PFrameDMCCoder(PFrameDMC(feat=16, N=32))


def _recorded_fns(seed=5, n=6, hw=64):
    """Deterministic per-frame stand-ins for the codecs (numpy values handed
    to both packages): intra_fn, pframe_fn (with bit split and warped
    frame) and warp_pred_fn, each in a tpuvc and a port flavour."""
    rng = np.random.default_rng(seed)
    frames = [np.clip(rng.random((1, hw, hw, 3), dtype=np.float32), 0, 1) for _ in range(n)]
    noise = {i: 0.05 * rng.standard_normal((1, hw, hw, 3)).astype(np.float32) for i in range(n)}
    gain = {r: float(g) for r, g in zip((1.0, 1.5, 2.0), (0.6, 1.0, 0.3))}

    def make(asarray):
        key = {}

        def idx(x):
            return key.setdefault(float(np.asarray(x).sum()), len(key))

        def intra_fn(x):
            i = idx(x)
            return asarray(frames[i] + noise[i]), asarray(np.float32(1000 + i))

        def pframe_fn(x, dpb, ratio):
            i = idx(x)
            x_hat = asarray(np.asarray(x) + 0.5 * noise[i])
            out = {"x_hat": x_hat, "bits": asarray(np.float32(300 + 7 * i)),
                   "bits_mv": asarray(np.float32(100 + i)), "bits_y": asarray(np.float32(200 + 6 * i))}
            out["dpb"] = {"ref_frame": x_hat, "ref_feature": None, "ref_down_ratio": ratio}
            return out

        def warp_pred_fn(x, ref, ratio):
            return asarray(np.asarray(x) + gain[ratio] * noise[idx(x)])

        return intra_fn, pframe_fn, warp_pred_fn

    return frames, make(jnp.asarray), make(_torch)


def _torch(a):
    return torch.from_numpy(np.asarray(a))


def test_eval_pframe_sequence_matches_tpuvc(tmp_path):
    """The same recorded codec outputs through both packages' low-delay
    loops (I every 4 frames, the ratio search with hysteresis over 1.0, 1.5,
    2.0): the same frame types, ratios and bits, PSNRs (each package's
    float32) within 1e-4 dB, in the diagnostics CSV too."""
    frames, jfns, tfns = _recorded_fns()
    out = {}
    for name, pr, fns, asarray in (("tpuvc", jpr, jfns, jnp.asarray),
                                   ("port", tpr, tfns, _torch)):
        diag = (jio if name == "tpuvc" else tio).PerFrameDiagnostics()
        seq = [asarray(f) for f in frames]
        ps, sizes = pr.eval_pframe_sequence(seq, len(seq), *fns, crop_hw=(64, 64),
                                            intra_period=4, ratios=(1.0, 1.5, 2.0),
                                            diagnostics=diag)
        out[name] = (ps, sizes, diag.write(str(tmp_path / f"{name}.csv")))
    (jp, js, jcsv), (tp, ts, tcsv) = out["tpuvc"], out["port"]
    np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
    assert ts == js
    trows, jrows = (list(csv.DictReader(open(f))) for f in (tcsv, jcsv))
    assert open(tcsv).readline() == open(jcsv).readline()
    assert [r["type"] for r in trows] == ["I", "P", "P", "P", "I", "P"]
    for t, j in zip(trows, jrows):
        for k in tio.PerFrameDiagnostics.FIELDS:
            if k in ("psnr", "warp_psnr") and j[k]:
                assert abs(float(t[k]) - float(j[k])) <= 1e-4, (k, t, j)
            else:
                assert t[k] == j[k], (k, t, j)
    # the search ran and chose by its scores: not every P at ratio 1.0
    assert {r["down_ratio"] for r in trows if r["type"] == "P"} != {"1.0"}


def test_per_frame_diagnostics_csv_bytes_match_tpuvc(tmp_path):
    rows = [dict(frame=0, type="I", down_ratio=1.0, psnr=31.25, bits=1000.5, bpp=0.25),
            dict(frame=1, type="P", down_ratio=1.5, psnr=30.125, warp_psnr=28.0625,
                 bits=300.0, bpp=0.0732421875, bits_mv=100.0, bits_y=200.0)]
    paths = []
    for mod in (jio, tio):
        diag = mod.PerFrameDiagnostics()
        for r in rows:
            diag.update(**r)
        paths.append(diag.write(str(tmp_path / f"{mod.__name__}.csv")))
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_eval_sequence_lowdelay_fixed_ratio_matches_tpuvc():
    """No ratio search (ratio 1.0 everywhere) and the info ledger filled."""
    from tpuvc.eval.infographic import TestInfographic as JInfo
    from tpuvc_torch.eval.infographic import TestInfographic as TInfo

    frames, jfns, tfns = _recorded_fns(seed=6)
    ji, ti = JInfo(), TInfo()

    def pf(fn):
        def run(x, dpb, ratio):
            o = fn(x, dpb, ratio)
            return o["x_hat"], o["bits"], o["dpb"], {}
        return run

    jrun.eval_sequence_lowdelay([jnp.asarray(f) for f in frames], 6, 3, jfns[0], pf(jfns[1]),
                                (64, 64), video="v", level=2, info=ji)
    trun.eval_sequence_lowdelay([torch.from_numpy(f) for f in frames], 6, 3, tfns[0],
                                pf(tfns[1]), (64, 64), video="v", level=2, info=ti)
    jrows = ji.dataframe().to_dict("records")
    assert [r["type"] for r in ti.rows] == [r["type"] for r in jrows] == ["I", "P", "P"] * 2
    for p, j in zip(ti.rows, jrows):
        assert abs(p["psnr"] - j["psnr"]) <= 1e-4 and p["size"] == j["size"]


def test_write_rd_txt_bytes_match_tpuvc(tmp_path):
    agg = [(0.1234567, 33.456), (0.25, 35.1)]
    per_seq = {"beauty": [(0.1, 34.0)], "jockey": [(0.2, 36.789)]}
    a = jio.write_rd_txt(str(tmp_path / "j.txt"), "DMC", "PSNR", agg, per_seq)
    b = tio.write_rd_txt(str(tmp_path / "t.txt"), "DMC", "PSNR", agg, per_seq)
    assert open(a).read() == open(b).read()
    assert os.path.getsize(b) > 0
