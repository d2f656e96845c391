"""tpuvc_torch.gop.adaptive and encode_v --adaptive against tpuvc on the CPU.

- The three searches run on the same candidate frames in both packages
  (numpy-seeded candidates whose PSNRs lie >= 1 dB apart, so float32
  rounding cannot reorder them) and must choose the same ratio with the
  same score (1e-4 dB / relative 1e-5).
- ``prediction_flowonly`` at down ratios 1, 2 and 4, flow and offset heads
  seeded, on the same parameters (``params_from_jax``): 2e-5 absolute.
- encode_v --adaptive in both packages, narrow FlowGuidedB (feature
  channels (16, 32, 48)) and small ELIC from the same seeded weights, on 9
  frames of a moving texture (GOP 4). FlowNET's flow head emits a
  near-constant flow of 6 px times the ratio (``v4_constant_flow_params``),
  so the candidates' predictions differ clearly: every frame's best
  candidate leads the next by at least 0.01 dB, while the packages' PSNRs
  of one candidate differ by at most 1e-3 dB. Both packages must choose
  the same ratio for every frame (ratio 2 for some) and write the same
  records; every reconstruction agrees within 2e-5; the port's decode_v
  reproduces the port's encoder bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import (
    V4_KW,
    filled_params,
    translating_frames,
    v4_constant_flow_params,
    write_sequence_checkpoints,
)
from tpuvc.coder import container as jcont
from tpuvc.gop import adaptive as ja
from tpuvc.models import flowguided_b as jf
from tpuvc_torch.coder import container as tcont
from tpuvc_torch.coder import parallel
from tpuvc_torch.gop import adaptive as ta
from tpuvc_torch.models import flowguided_b as tf
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)


def _candidates(ratios, seed=0, gaps_db=None):
    """xcur and one prediction per ratio: xcur plus gaussian noise whose
    level gives each candidate the PSNR in ``gaps_db`` (dB, by ratio)."""
    rng = np.random.default_rng(seed)
    xcur = rng.random((1, 32, 32, 3), dtype=np.float32)
    preds = {}
    for r in ratios:
        sigma = 10 ** (-gaps_db[r] / 20)
        preds[r] = (xcur + sigma * rng.standard_normal(xcur.shape)).astype(np.float32)
    return xcur, preds


def _both(fn_name, xcur, preds, **kw):
    """Run one search in both packages on the same candidates."""
    jx = jnp.asarray(xcur)
    ref = getattr(ja, fn_name)(lambda r: jnp.asarray(preds[r]), jx, **kw)
    out = getattr(ta, fn_name)(lambda r: torch.from_numpy(preds[r]), torch.from_numpy(xcur), **kw)
    return out, ref


def test_constants_match_tpuvc():
    assert ta.V4_RATIOS == ja.V4_RATIOS
    assert ta.OJSP_RATIOS == ja.OJSP_RATIOS and ta.OJSP_BIAS == ja.OJSP_BIAS


@pytest.mark.parametrize("best", [1, 4, 16])
def test_best_down_ratio_prediction_matches_tpuvc(best):
    gaps = {r: 20.0 + 3.0 * i for i, r in enumerate(ta.V4_RATIOS)}
    gaps[best] = 40.0
    xcur, preds = _candidates(ta.V4_RATIOS, seed=best, gaps_db=gaps)
    (ratio, p), (jratio, jp) = _both("best_down_ratio_prediction", xcur, preds)
    assert ratio == jratio == best
    assert abs(p - jp) <= 1e-4


def test_psnr_of_matches_tpuvc():
    xcur, preds = _candidates((1,), gaps_db={1: 25.0})
    ref = float(ja.psnr_of(jnp.asarray(preds[1]), jnp.asarray(xcur)))
    out = float(ta.psnr_of(torch.from_numpy(preds[1]), torch.from_numpy(xcur)))
    assert abs(out - ref) <= 1e-4 and abs(out - 25.0) < 0.5


@pytest.mark.parametrize("beta", [0.01, 1e4])
def test_best_down_ratio_rd_matches_tpuvc(beta):
    """Low beta: the rate decides (the cheapest ratio); high beta: the
    distortion does (the most accurate one)."""
    rng = np.random.default_rng(3)
    xcur = rng.random((1, 16, 16, 3), dtype=np.float32)
    sigma = {1: 0.01, 2: 0.05, 4: 0.1, 8: 0.2, 16: 0.3}
    rate = {1: 2.0, 2: 1.5, 4: 1.0, 8: 0.6, 16: 0.2}
    x_hat = {r: (xcur + s * rng.standard_normal(xcur.shape)).astype(np.float32)
             for r, s in sigma.items()}
    rates = {r: np.full((4,), v, np.float32) for r, v in rate.items()}
    ref = ja.best_down_ratio_rd(lambda r: (jnp.asarray(x_hat[r]), jnp.asarray(rates[r])),
                                jnp.asarray(xcur), beta)
    out = ta.best_down_ratio_rd(
        lambda r: (torch.from_numpy(x_hat[r]), torch.from_numpy(rates[r])),
        torch.from_numpy(xcur), beta,
    )
    assert out[0] == ref[0] == (16 if beta < 1 else 1)
    assert abs(out[1] / ref[1] - 1) <= 1e-5


RATIOS = (1.0, 1.5, 2.0, 3.0, 4.0)


@pytest.mark.parametrize("prev, psnrs, chosen", [
    (None, {1.0: 30, 1.5: 31, 2.0: 34, 3.0: 32, 4.0: 29}, 2.0),  # no previous ratio
    (3.0, {1.0: 30, 1.5: 31, 2.0: 34, 3.0: 32, 4.0: 29}, 2.0),   # best wins by 2 dB: switch
    (1.5, {1.0: 30, 1.5: 33.95, 2.0: 34, 3.0: 32, 4.0: 29}, 1.5),  # within 0.1 dB: keep
    (2.0, {1.0: 30, 1.5: 31, 2.0: 34, 3.0: 32, 4.0: 29}, 2.0),   # previous is the best
    (2.5, {1.0: 30, 1.5: 31, 2.0: 34, 3.0: 32, 4.0: 29}, 2.0),   # previous not a candidate
])
def test_fractional_ratio_search_matches_tpuvc(prev, psnrs, chosen):
    """The hysteresis: keep the previous frame's ratio unless the best
    candidate beats it by the 0.1 dB bias. Candidates are exact scalings of
    one residual, so each PSNR is the one asked for within float32."""
    rng = np.random.default_rng(5)
    xcur = np.full((1, 32, 32, 3), 0.5, np.float32)
    noise = rng.choice([-1.0, 1.0], size=xcur.shape).astype(np.float32)
    preds = {r: (xcur + 10 ** (-p / 20) * noise).astype(np.float32) for r, p in psnrs.items()}
    out, ref = _both("fractional_ratio_search", xcur, preds, prev_ratio=prev, ratios=RATIOS)
    assert out[0] == ref[0] == chosen
    np.testing.assert_allclose(out[1:], ref[1:], atol=1e-4)
    assert abs(out[2] - 34.0) < 1e-3


@pytest.fixture(scope="module")
def seeded_pair():
    """Narrow FlowGuidedB in both packages on the same seeded parameters,
    flow and offset heads seeded (tests/test_torch_flowguided.py's)."""
    jm = jf.FlowGuidedB(**V4_KW)
    x = jnp.zeros((1, 64, 64, 3))
    v = filled_params(
        lambda: jm.init(jax.random.key(0), x, x, x, 1, 0.5, -0.5, 1, "dequantize"),
        seed=0, scale={"params/flow_estimator/SubpelConv_3": 1.0,
                       **{f"params/offset_compressor/g_o{i}/Conv_1": 0.05 for i in (1, 2, 3)}},
    )
    tm = tf.FlowGuidedB(**V4_KW)
    tm.load_state_dict(params_from_jax(v), strict=True)
    return jm, v, tm.eval()


@pytest.mark.parametrize("down_ratio", [1, 2, 4])
def test_flowonly_prediction_matches_tpuvc(seeded_pair, down_ratio):
    jm, v, tm = seeded_pair
    rng = np.random.default_rng(down_ratio)
    x1 = rng.random((1, 64, 64, 3), dtype=np.float32)
    x2 = np.clip(x1 + 0.05 * rng.standard_normal(x1.shape), 0, 1).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(x1), jnp.asarray(x2), 0.5, 0.5, down_ratio,
                   method=jf.FlowGuidedB.prediction_flowonly)
    with torch.no_grad():
        out = tm.prediction_flowonly(torch.from_numpy(x1), torch.from_numpy(x2), 0.5, 0.5,
                                     down_ratio)
        # the flow it warped by is fractional and nonzero
        flow = tm.estimate_flow(torch.from_numpy(x1), torch.from_numpy(x2), down_ratio)
    assert float(flow.abs().max()) > 0.1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


SEQ_ARGS = ["--gop", "4", "--family", "flowguided_b", "--adaptive", "--s", "1.0"]
INTRA_ARGS = ["--intra_N", "16", "--intra_M", "24", "--intra_groups", "4,4,16"]


@pytest.fixture(scope="module")
def adaptive_setup(tmp_path_factory):
    """9 translating 64x64 PNG frames, tpuvc-written ELIC weights and the
    constant-flow FlowGuidedB parameters."""
    from tpuvc_torch.data.frames import save_png

    root = tmp_path_factory.mktemp("adaptive")
    frames = root / "frames"
    frames.mkdir()
    for i, img in enumerate(translating_frames(9, 64, 64)):
        save_png(str(frames / f"{i:03d}.png"), img)
    write_sequence_checkpoints(root)
    jm, v = v4_constant_flow_params(flow=3.0)
    tm = tf.FlowGuidedB(**V4_KW)
    tm.load_state_dict(params_from_jax(v), strict=True)
    load = INTRA_ARGS + ["--init", "load", "--weights_intra", str(root / "elic.msgpack")]
    yield str(frames), load, (jm, v), tm
    parallel.shutdown()


def _ratios(text):
    import re

    return {int(i): int(r) for i, r in re.findall(r"frame +(\d+): down_ratio (\d+)", text)}


def test_encode_v_adaptive_matches_tpuvc(tmp_path, monkeypatch, capsys, adaptive_setup):
    from tpuvc.cli import encode_b as jencode_b
    from tpuvc.cli import encode_v as jencode_v
    from tpuvc.models.elic import ELICCoder as JELICCoder
    from tpuvc_torch.cli import decode_v, encode_b, encode_v

    frames, load, (jm, v), tm = adaptive_setup
    monkeypatch.setattr(encode_b, "load_model", lambda args: tm)
    monkeypatch.setattr(jencode_b, "load_model", lambda args: (jm, {"params": v["params"]}))
    argv = ["--frames", frames] + SEQ_ARGS + load
    port_bin, ref_bin = str(tmp_path / "port.tpvb"), str(tmp_path / "ref.tpvb")

    scores = {"port": [], "tpuvc": []}  # each search's candidate PSNRs
    for key, mod in (("port", ta), ("tpuvc", ja)):
        def psnr_spy(pred, x, _orig=mod.psnr_of, _key=key):
            p = _orig(pred, x)
            scores[_key].append(float(p))
            return p
        monkeypatch.setattr(mod, "psnr_of", psnr_spy)

    recons = encode_v.main(argv + ["--device", "cpu", "--bin", port_bin])
    port_ratios = _ratios(capsys.readouterr().out)

    ref_frames = {"I": [], "B": []}
    spied = {"I": (JELICCoder, "synthesize"), "B": (jf.FlowGuidedBCoder, "encode_recon")}
    for typ, (cls, name) in spied.items():
        def spy(self, *a, _orig=getattr(cls, name), _typ=typ, **kw):
            out = _orig(self, *a, **kw)
            x = out[1] if _typ == "B" else out
            ref_frames[_typ].extend(np.clip(np.asarray(x, np.float32), 0, 1))
            return out
        monkeypatch.setattr(cls, name, spy)
    jencode_v.main(argv + ["--bin", ref_bin])
    ref_ratios = _ratios(capsys.readouterr().out)

    # Six searches of five candidates each; a clear winner every time.
    port_ps, ref_ps = (np.array(scores[k]).reshape(6, 5) for k in ("port", "tpuvc"))
    assert np.abs(port_ps - ref_ps).max() <= 1e-3
    top2 = np.sort(ref_ps, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() >= 0.01
    assert port_ratios == ref_ratios
    assert sorted(port_ratios) == [1, 2, 3, 5, 6, 7] and max(port_ratios.values()) > 1
    port = tcont.VSequenceBitstream.deserialize(open(port_bin, "rb").read())
    ref = jcont.VSequenceBitstream.deserialize(open(ref_bin, "rb").read())
    header = ("family", "width", "height", "gop", "n_frames", "mode", "dtype")
    assert {k: getattr(port, k) for k in header} == {k: getattr(ref, k) for k in header}
    records = [(t, i) for t, i, _ in port.frames]
    assert records == [(t, i) for t, i, _ in ref.frames]
    fields = ("s_milli", "down_ratio", "scale1_centi", "scale2_centi", "z_shape")
    for (t, i, blob), (_, _, jblob) in zip(port.frames, ref.frames):
        if t == "B":
            a, b = tcont.VFrameBitstream.deserialize(blob), jcont.VFrameBitstream.deserialize(jblob)
            assert {k: getattr(a, k) for k in fields} == {k: tuple(b.z_shape) if k == "z_shape"
                                                          else getattr(b, k) for k in fields}
            assert a.down_ratio == port_ratios[i]
    order = {typ: [i for t, i in records if t == typ] for typ in ("I", "B")}
    for typ in ("I", "B"):
        assert len(ref_frames[typ]) == len(order[typ])
        for idx, x_ref in zip(order[typ], ref_frames[typ]):
            np.testing.assert_allclose(recons[idx].numpy(), x_ref, atol=2e-5, rtol=0,
                                       err_msg=f"{typ} frame {idx}")

    # The port's decoder replays each frame's ratio from its stream.
    dec = decode_v.main(["--bin", port_bin, "--out_dir", str(tmp_path / "dec"),
                         "--device", "cpu"] + load)
    assert sorted(dec) == sorted(recons) == list(range(9))
    assert all(torch.equal(dec[i], recons[i]) for i in recons)
    assert os.path.exists(tmp_path / "dec")
