"""The port's encode_v and encode_p against tpuvc's on the same frames and
the same weights, on the CPU.

Both CLIs run with ``--init load`` from checkpoints that tpuvc's
``save_checkpoint`` wrote (tpuvc's tests/test_vseq_cli.py model sizes,
LHBDC N=32, ELIC N=16 M=24 groups (4, 4, 16); 9 synthetic 64x64 frames at
GOP 4), once in the sequential mode (the DPB picks every B-frame's
references) and once level-batched over 2-GOP windows at batch 2 (levels
cut into chunks, the window's anchors coded together). The files must
carry the same header and the same (type, display index) records in the
same order, so tpuvc's decode_v replays the port's files in the order it
expects. tpuvc's reconstructions are read off its coders as encode_v
calls them: every frame must be within the LHBDC/ELIC forward bar of the
port's (2e-5 absolute; ROADMAP.md C).

encode_p codes 5 frames of a texture moving 2 px a frame (128x128 PNGs;
I P P P I) with DMC at tpuvc's test size (feat 16, N 32), whose SPyNet
emits a near-constant flow (``dmc_params(flow=-1.25)``), with
``--adaptive`` over 1.0, 1.25, 1.5, 2.0: every search's decision has a
margin of at least 0.01 dB (checked), so both packages must choose the
same ratios. Each
reconstruction must lie within the forward bar of tpuvc's, and the file
sizes within 1%; the streams need not be byte-equal (ROADMAP.md C).
"""

import numpy as np
import pytest
import torch

from torch_params_common import translating_frames, write_dmc_checkpoints, write_sequence_checkpoints
from tpuvc.coder import container as jcont
from tpuvc.models.elic import ELICCoder as JELICCoder
from tpuvc.models.lhbdc import LHBDCCoder as JLHBDCCoder
from tpuvc_torch.coder import container as tcont
from tpuvc_torch.coder import parallel

torch.set_num_threads(1)

ARGS = [
    "--synthetic", "9", "--width", "64", "--height", "64", "--gop", "4",
    "--N", "32", "--intra_N", "16", "--intra_M", "24", "--intra_groups", "4,4,16",
    "--l", "845",
]
MODES = {
    "sequential": [],
    "level_batched": ["--level_batched", "--window_gops", "2", "--max_batch", "2"],
}


@pytest.fixture(scope="module")
def load_args(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("weights")
    write_sequence_checkpoints(wdir)
    yield ["--init", "load", "--weights", str(wdir),
           "--weights_intra", str(wdir / "elic.msgpack")]
    parallel.shutdown()


def _tpuvc_encode(argv, monkeypatch):
    """tpuvc's encode_v.main on argv -> the reconstructions its coders
    returned, in call order: ([I frames], [B frames]), each (H, W, 3)."""
    from tpuvc.cli import encode_v

    intra, inter = [], []
    synthesize = JELICCoder.synthesize
    encode_recon = JLHBDCCoder.encode_recon
    encode_batch = JLHBDCCoder.encode_level_batch_async

    def frames(x):
        return list(np.clip(np.asarray(x, np.float32), 0.0, 1.0))

    def spy_synthesize(self, y_hat):
        out = synthesize(self, y_hat)
        intra.extend(frames(out))
        return out

    def spy_encode_recon(self, *a, **kw):
        bits, x_hat = encode_recon(self, *a, **kw)
        inter.extend(frames(x_hat))
        return bits, x_hat

    def spy_encode_batch(self, *a, **kw):
        resolve, x_hat = encode_batch(self, *a, **kw)
        inter.extend(frames(x_hat))
        return resolve, x_hat

    monkeypatch.setattr(JELICCoder, "synthesize", spy_synthesize)
    monkeypatch.setattr(JLHBDCCoder, "encode_recon", spy_encode_recon)
    monkeypatch.setattr(JLHBDCCoder, "encode_level_batch_async", spy_encode_batch)
    encode_v.main(argv)
    return intra, inter


@pytest.mark.parametrize("mode", sorted(MODES))
def test_encode_v_matches_tpuvc(tmp_path, monkeypatch, load_args, mode):
    from tpuvc_torch.cli import encode_v

    argv = ARGS + MODES[mode] + load_args
    port_bin, ref_bin = str(tmp_path / "port.tpvb"), str(tmp_path / "ref.tpvb")
    recons = encode_v.main(argv + ["--device", "cpu", "--bin", port_bin])
    intra, inter = _tpuvc_encode(argv + ["--bin", ref_bin], monkeypatch)

    port = tcont.VSequenceBitstream.deserialize(open(port_bin, "rb").read())
    ref = jcont.VSequenceBitstream.deserialize(open(ref_bin, "rb").read())
    header = ("family", "width", "height", "gop", "n_frames", "mode", "max_batch",
              "dtype", "window_gops", "mesh")
    assert {k: getattr(port, k) for k in header} == {k: getattr(ref, k) for k in header}
    records = [(t, i) for t, i, _ in port.frames]
    assert records == [(t, i) for t, i, _ in ref.frames]
    if mode == "level_batched":
        # one window: its three anchors, then levels 1 and 2 in chunks of 2
        assert records == [("I", 0), ("I", 4), ("I", 8), ("B", 2), ("B", 6),
                           ("B", 1), ("B", 5), ("B", 3), ("B", 7)]

    # tpuvc's coders ran in record order: I frames, and B frames, each in
    # the order their records appear in the file.
    order = {"I": [i for t, i in records if t == "I"], "B": [i for t, i in records if t == "B"]}
    assert (len(intra), len(inter)) == (len(order["I"]), len(order["B"]))
    for typ, ref_frames in (("I", intra), ("B", inter)):
        for idx, x_ref in zip(order[typ], ref_frames):
            np.testing.assert_allclose(recons[idx].numpy(), x_ref[:64, :64], atol=2e-5, rtol=0,
                                       err_msg=f"{typ} frame {idx}")


def test_encode_p_matches_tpuvc(tmp_path, monkeypatch):
    from tpuvc.cli import encode_p as jencode_p
    from tpuvc.gop import adaptive as ja
    from tpuvc.models.dmc import PFrameDMCCoder as JPFrameDMCCoder
    from tpuvc_torch.cli import encode_p
    from tpuvc_torch.data.frames import save_png
    from tpuvc_torch.gop import adaptive as ta

    (tmp_path / "moving").mkdir()
    for i, img in enumerate(translating_frames(5, 128, 128)):
        save_png(str(tmp_path / "moving" / f"{i:03d}.png"), img)
    write_dmc_checkpoints(tmp_path, flow=-1.25)
    argv = ["--frames", str(tmp_path / "moving"), "--intra_period", "4", "--adaptive",
            "--ratios", "1.0,1.25,1.5,2.0", "--q", "0.5", "--init", "load",
            "--weights_dmc", str(tmp_path / "dmc.msgpack"),
            "--weights_intra", str(tmp_path / "elic.msgpack"),
            "--feat", "16", "--N", "32", "--intra_N", "16", "--intra_M", "24",
            "--intra_groups", "4,4,16"]
    scores = {"port": [], "tpuvc": []}
    for key, mod in (("port", ta), ("tpuvc", ja)):
        def psnr_spy(pred, x, _orig=mod.psnr_of, _key=key):
            p = _orig(pred, x)
            scores[_key].append(float(p))
            return p
        monkeypatch.setattr(mod, "psnr_of", psnr_spy)

    port_bin, ref_bin = str(tmp_path / "port.tpvs"), str(tmp_path / "ref.tpvs")
    recons = encode_p.main(argv + ["--device", "cpu", "--bin", port_bin])

    ref_recons = []
    synthesize, encode_async = JELICCoder.synthesize, JPFrameDMCCoder.encode_async

    def spy_synthesize(self, y_hat):
        out = synthesize(self, y_hat)
        ref_recons.append(np.clip(np.asarray(out[0], np.float32), 0.0, 1.0))
        return out

    def spy_encode_async(self, *a, **kw):
        fut, dpb = encode_async(self, *a, **kw)
        ref_recons.append(np.asarray(dpb["ref_frame"][0], np.float32))
        return fut, dpb

    monkeypatch.setattr(JELICCoder, "synthesize", spy_synthesize)
    monkeypatch.setattr(JPFrameDMCCoder, "encode_async", spy_encode_async)
    jencode_p.main(argv + ["--bin", ref_bin])

    port_blob, ref_blob = open(port_bin, "rb").read(), open(ref_bin, "rb").read()
    port = tcont.PSequenceBitstream.deserialize(port_blob)
    ref = jcont.PSequenceBitstream.deserialize(ref_blob)
    assert (port.width, port.height) == (ref.width, ref.height) == (128, 128)
    assert [t for t, _ in port.frames] == [t for t, _ in ref.frames] == ["I", "P", "P", "P", "I"]
    headers = [[(b.q_milli, b.ratio_centi, b.z_shape) for b in
                (cls.deserialize(blob) for t, blob in seq.frames if t == "P")]
               for cls, seq in ((tcont.PFrameBitstream, port), (jcont.PFrameBitstream, ref))]
    assert headers[0] == headers[1]
    # Three searches of four candidates: the packages' scores agree, and
    # each decision (the best candidate, and whether it beats the previous
    # frame's ratio by the 0.1 dB bias) has a clear margin.
    port_ps, ref_ps = (np.array(scores[k]).reshape(3, 4) for k in ("port", "tpuvc"))
    assert np.abs(port_ps - ref_ps).max() <= 1e-3
    top2 = np.sort(ref_ps, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() >= 0.01
    prev = [0] + [[100, 125, 150, 200].index(r) for _, r, _ in headers[1][:-1]]
    gain = ref_ps.max(axis=1) - ref_ps[np.arange(3), prev]
    assert np.all((gain == 0) | (np.abs(gain - 0.1) >= 0.01))
    assert abs(len(port_blob) / len(ref_blob) - 1.0) <= 0.01
    assert len(ref_recons) == 5
    for i, x_ref in enumerate(ref_recons):
        np.testing.assert_allclose(recons[i].numpy(), x_ref[:128, :128], atol=2e-5, rtol=0,
                                   err_msg=f"frame {i}")
