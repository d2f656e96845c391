"""The RD-eval CLI's level loop (``cli.test._run_levels``) in both packages
on the same small packs, frames and configuration, on the CPU.

- LHBDC (N=32) level-batched (GOP 4, 2-GOP windows, batch cap 2) with the
  MS-SSIM column, on 9 synthetic 176x176 frames (MS-SSIM needs 176 px a
  side).
- FlowGuidedB (narrow: feature channels (16, 32, 48), N=M=32) sequential
  with the down-ratio search, on 9 frames of a moving 64x64 texture read
  from PNGs. FlowNET's flow head emits a near-constant flow of 6 px times
  the ratio (``v4_constant_flow_params``) and the offset heads are seeded,
  so the candidates differ clearly: each search's best candidate leads the
  next by at least 0.01 dB, while the packages' PSNRs of one candidate
  differ by at most 1e-3 dB.

- DeformB (tpuvc's small v3: feature channels (8, 16, 24), N=M=32, 3
  levels) sequential and level-batched on 9 synthetic 64x64 frames at
  rate level 1, its offset heads seeded.
- Flex-Rate (N=32, 4 gain levels) sequential and level-batched on 9
  synthetic 128x128 frames (its hyperprior codes at /64) at RD points 2
  and 5, each B-frame's (n, l) from the point's table by its hierarchy
  level; the flow refinement's synthesis seeded.

- DMC (tpuvc's test size: feat 16, N 32) low-delay at rate level 1 on 5
  frames of a 128x128 texture moving 2 px a frame (I P P P P), the
  fractional search over 1.0, 1.25, 1.5, 2.0 on a near-constant SPyNet
  flow (``dmc_params(flow=-1.25)``), with the per-frame diagnostics CSV.
  Its bits are held at 1e-4 relative: tpuvc's float32 totals of DMC's
  likelihoods carry up to 5e-5 of accumulation rounding against their
  float64 sum (tests/test_torch_dmc.py holds the bits at 1e-6 on float64
  sums).

All use ELIC (N=16, M=24) for the I-frames. Per-frame rows match: PSNR
within 1e-4 dB, bits within 1e-5 relative (float32 totals, ROADMAP.md C),
MS-SSIM within 1e-5; the chosen ratios are equal. Both configurations are
made by each package's own ``apply_overrides`` from the same overrides.
"""

import collections
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import (
    V4_KW,
    dmc_params,
    filled_params,
    translating_frames,
    v4_constant_flow_params,
    write_sequence_checkpoints,
)
from tpuvc.eval.infographic import TestInfographic as JInfo
from tpuvc_torch.eval.infographic import TestInfographic as TInfo
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

V3_KW = dict(feature_channels=(8, 16, 24), N=32, M=32, levels=3, groups=(4, 4, 8, 16))
FLEXRATE_KW = dict(n_levels=4, N=32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from tpuvc.models.deform_b import DeformB as JDeformB
    from tpuvc.models.elic import ELIC as JELIC
    from tpuvc.models.flexrate import BidirFlowRef as JBidirFlowRef
    from tpuvc.models.lhbdc import LHBDC as JLHBDC
    from tpuvc_torch.data.frames import save_png
    from tpuvc_torch.models.deform_b import DeformB
    from tpuvc_torch.models.elic import ELIC
    from tpuvc_torch.models.flexrate import BidirFlowRef
    from tpuvc_torch.models.flowguided_b import FlowGuidedB
    from tpuvc_torch.models.lhbdc import LHBDC

    from tpuvc_torch.models.dmc import PFrameDMC

    root = tmp_path_factory.mktemp("eval_cli")
    for name, n, hw in (("moving", 9, 64), ("moving128", 5, 128)):
        (root / name).mkdir()
        for i, img in enumerate(translating_frames(n, hw, hw)):
            save_png(str(root / name / f"{i:03d}.png"), img)
    jdmc, dmc = dmc_params(flow=-1.25)
    lhbdc, elic = write_sequence_checkpoints(root)
    jv4, v4 = v4_constant_flow_params(flow=3.0)
    x64, x128 = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 128, 128, 3))
    jv3 = JDeformB(**V3_KW)
    v3 = filled_params(lambda: jv3.init(jax.random.key(0), x64, x64, x64, 1, "dequantize"),
                       seed=1, scale={f"params/offset_compressor/g_o{i}/Conv_1": 1.0
                                      for i in (1, 2, 3)})
    jfr = JBidirFlowRef(**FLEXRATE_KW)
    fr = filled_params(lambda: jfr.init(jax.random.key(0), x128, x128, x128, 0, 1.0,
                                        "dequantize"),
                       seed=2, scale={f"params/{c}/g_s_layers_7": 0.1
                                      for c in ("flow_compressor", "residual_compressor")})

    def port(module, tree):
        module.load_state_dict(params_from_jax(tree), strict=True)
        return module.eval()

    return {
        "root": str(root),
        "intra": ((JELIC(N=16, M=24, groups=(4, 4, 16)), elic),
                  port(ELIC(N=16, M=24, groups=(4, 4, 16)), elic)),
        "lhbdc": ((JLHBDC(N=32), lhbdc), port(LHBDC(N=32), lhbdc)),
        "flowguided_b": ((jv4, v4), port(FlowGuidedB(**V4_KW), v4)),
        "deform_b": ((jv3, v3), port(DeformB(**V3_KW), v3)),
        "flexrate": ((jfr, fr), port(BidirFlowRef(**FLEXRATE_KW), fr)),
        "dmc": ((jdmc, dmc), port(PFrameDMC(feat=16, N=32), dmc)),
    }


def _run_both(setup, family, overrides, monkeypatch):
    """Both packages' _run_levels on the same overrides -> (port rows,
    tpuvc rows, port ratio Counter, candidate PSNRs by package)."""
    from tpuvc import config as jconfig
    from tpuvc.cli import test as jtest
    from tpuvc.gop import adaptive as ja
    from tpuvc_torch import config as tconfig
    from tpuvc_torch.cli import test as ttest
    from tpuvc_torch.gop import adaptive as ta

    scores = {"port": [], "tpuvc": []}
    for key, mod in (("port", ta), ("tpuvc", ja)):
        def psnr_spy(pred, x, _orig=mod.psnr_of, _key=key):
            p = _orig(pred, x)
            scores[_key].append(float(p))
            return p
        monkeypatch.setattr(mod, "psnr_of", psnr_spy)

    overrides = [f"model.family={family}", f"dataset.root={setup['root']}"] + overrides
    jcfg = jconfig.apply_overrides(jconfig.TestConfig(), overrides)
    tcfg = tconfig.apply_overrides(tconfig.TestConfig(), overrides)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    extra = ("msssim",) if tcfg.eval_msssim else ()
    jinfo, tinfo = JInfo(extra), TInfo(extra)
    jtest._run_levels(jcfg, setup["intra"][0], setup[family][0], jinfo)
    ratios = ttest._run_levels(tcfg, setup["intra"][1], setup[family][1], tinfo, torch.device("cpu"))
    return tinfo.rows, jinfo.dataframe().to_dict("records"), ratios, scores


def _check_rows(prows, jrows, size_rel=1e-5):
    key = ("video", "level", "frame_num", "type", "pixels")
    assert [tuple(r[k] for k in key) for r in prows] == [tuple(r[k] for k in key) for r in jrows]
    for p, j in zip(prows, jrows):
        assert abs(p["psnr"] - j["psnr"]) <= 1e-4, (p, j)
        assert p["size"] == pytest.approx(j["size"], rel=size_rel), (p, j)
        if "msssim" in j:
            assert abs(p["msssim"] - j["msssim"]) <= 1e-5, (p, j)


def test_run_levels_lhbdc_level_batched_matches_tpuvc(setup, monkeypatch):
    prows, jrows, ratios, _ = _run_both(setup, "lhbdc", [
        "dataset.name=synthetic", "dataset.sequences={'synth': 9}", "dataset.gop=4",
        "dataset.width=176", "dataset.height=176", "levels=(0,)", "level_batched=True",
        "window_gops=2", "max_batch=2", "eval_msssim=True",
    ], monkeypatch)
    assert len(prows) == 9 and ratios == collections.Counter()
    assert all(0 < r["msssim"] < 1 for r in prows)
    _check_rows(prows, jrows)


def test_run_levels_flowguided_adaptive_matches_tpuvc(setup, monkeypatch):
    prows, jrows, ratios, scores = _run_both(setup, "flowguided_b", [
        "dataset.name=UVG", "dataset.sequences={'moving': 9}", "dataset.gop=4",
        "levels=(1,)", "adaptive_down_ratio=True",
    ], monkeypatch)
    assert len(prows) == 9 and sum(ratios.values()) == 6
    # Six searches of five candidates each; a clear winner every time.
    port_ps, ref_ps = (np.array(scores[k]).reshape(6, 5) for k in ("port", "tpuvc"))
    assert np.abs(port_ps - ref_ps).max() <= 1e-3
    top2 = np.sort(ref_ps, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() >= 0.01
    ref_ratios = collections.Counter(int(np.array((1, 2, 4, 8, 16))[i])
                                     for i in np.argmax(ref_ps, axis=1))
    assert ratios == ref_ratios and max(ratios) > 1
    _check_rows(prows, jrows)


V3_FLEXRATE_RUNS = {
    "deform_b_sequential": ("deform_b", 64, ["levels=(1,)"]),
    "deform_b_level_batched": ("deform_b", 64, ["levels=(1,)", "level_batched=True",
                                                "window_gops=2", "max_batch=2"]),
    "flexrate_sequential": ("flexrate", 128, ["levels=(2,)"]),
    "flexrate_level_batched": ("flexrate", 128, ["levels=(5,)", "level_batched=True",
                                                 "window_gops=2", "max_batch=4"]),
}


@pytest.mark.parametrize("run", list(V3_FLEXRATE_RUNS))
def test_run_levels_v3_and_flexrate_match_tpuvc(setup, monkeypatch, run):
    family, hw, overrides = V3_FLEXRATE_RUNS[run]
    prows, jrows, ratios, _ = _run_both(setup, family, [
        "dataset.name=synthetic", "dataset.sequences={'synth': 9}", "dataset.gop=4",
        f"dataset.width={hw}", f"dataset.height={hw}",
    ] + overrides, monkeypatch)
    assert len(prows) == 9 and ratios == collections.Counter()
    assert sum(r["type"] == "B" for r in prows) == 6
    _check_rows(prows, jrows)


def test_run_levels_dmc_matches_tpuvc(setup, monkeypatch, tmp_path):
    """DMC's low-delay level (``_run_dmc_level``): the same rows, the same
    ratio choices (each search's decisions with a clear margin) and the
    same diagnostics CSV, up to each package's float32 PSNR and bits."""
    import csv

    from tpuvc.eval import results_io as jio

    write = jio.PerFrameDiagnostics.write
    monkeypatch.setattr(jio.PerFrameDiagnostics, "write",
                        lambda self, path: write(self, path + ".tpuvc"))
    ratios_list = (1.0, 1.25, 1.5, 2.0)
    prows, jrows, ratios, scores = _run_both(setup, "dmc", [
        "dataset.name=UVG", "dataset.sequences={'moving128': 5}", "levels=(1,)",
        "dmc_intra_period=5", f"dmc_ratios={ratios_list}", "adaptive_down_ratio=True",
        "dmc_diag_csv=diag.csv", f"output_dir={tmp_path}",
    ], monkeypatch)
    assert [r["type"] for r in prows] == ["I", "P", "P", "P", "P"]
    _check_rows(prows, jrows, size_rel=1e-4)
    # Four searches of four candidates (the diagnostics' warp PSNR is one
    # more psnr_of call a P-frame in each package).
    port_ps, ref_ps = (np.array(scores[k]).reshape(4, 5)[:, :4] for k in ("port", "tpuvc"))
    assert np.abs(port_ps - ref_ps).max() <= 1e-3
    top2 = np.sort(ref_ps, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() >= 0.01
    path = str(tmp_path / "moving128_l1_diag.csv")
    trows, jrows_csv = (list(csv.DictReader(open(f))) for f in (path, path + ".tpuvc"))
    assert open(path).readline() == open(path + ".tpuvc").readline()
    chosen = [float(r["down_ratio"]) for r in trows if r["type"] == "P"]
    assert chosen == [float(r["down_ratio"]) for r in jrows_csv if r["type"] == "P"]
    assert ratios == collections.Counter(chosen) and set(chosen) <= set(ratios_list)
    for t, j in zip(trows, jrows_csv):
        assert (t["frame"], t["type"]) == (j["frame"], j["type"])
        for k in ("psnr", "warp_psnr"):
            if j[k]:
                assert abs(float(t[k]) - float(j[k])) <= 1e-4, (k, t, j)
        for k in ("bits", "bpp", "bits_mv", "bits_y"):
            if j[k]:
                assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-4), (k, t, j)
            else:
                assert t[k] == j[k] == ""


@pytest.mark.parametrize("override, match", [
    ("write_plots=True", "matplotlib"),
])
def test_unported_options_exit_with_their_roadmap_item(tmp_path, monkeypatch, override, match):
    """An option this machine cannot run exits before the eval:
    write_plots without matplotlib (hidden here) names the package.
    (device_count=2 runs on one device, as in tpuvc:
    test_torch_mesh_cli.py.)"""
    from tpuvc_torch.cli import test as ttest

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match=match):
        ttest.main(["--device", "cpu", f"output_dir={tmp_path}", override])


def test_eval_cli_defaults_to_cuda_without_fallback(tmp_path):
    from tpuvc_torch.cli import test as ttest

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttest.main([f"output_dir={tmp_path}"])


def test_load_weights_reads_tpuvc_checkpoints(tmp_path, capsys):
    """``{dir}/latest.msgpack`` written by tpuvc's save_checkpoint loads into
    the port's module through params_from_jax; a missing file leaves the
    seeded weights."""
    from tpuvc.utils.checkpoint import save_checkpoint
    from tpuvc_torch.cli.test import load_weights
    from tpuvc_torch.models.elic import ELIC

    _, elic = write_sequence_checkpoints(tmp_path)
    (tmp_path / "intra").mkdir()
    save_checkpoint(str(tmp_path / "intra" / "latest.msgpack"), elic)
    module = ELIC(N=16, M=24, groups=(4, 4, 16), generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in module.state_dict().items()}
    load_weights(module, str(tmp_path / "nowhere"), "intra")
    assert all(torch.equal(before[k], v) for k, v in module.state_dict().items())
    load_weights(module, str(tmp_path / "intra"), "intra")
    assert "loaded intra weights" in capsys.readouterr().out
    expected = params_from_jax(elic)
    assert all(torch.equal(module.state_dict()[k], v) for k, v in expected.items())
