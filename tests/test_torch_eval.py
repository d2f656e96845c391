"""The port's eval layer against tpuvc's on the CPU: MS-SSIM, the results
ledger, the level-batched scheduler and both sequence runners.

Bars: MS-SSIM 1e-5 absolute; aggregations equal and the results CSV
byte-identical; the scheduler's calls, batches, decoded frames and sizes
identical (one deterministic inter_fn serves both packages); the runners'
PSNR within 1e-4 dB and each frame's bits within 1e-5 relative (the
float32 totals bar of the port's model tests; the 1e-6 bar holds on
float64 sums only, ROADMAP.md C), both packages running small LHBDC
(N=32) and ELIC (N=16, M=24) on the same seeded weights through their own
``cli.test.make_frame_fns`` / ``make_batched_inter_fn``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import write_sequence_checkpoints
from tpuvc.eval import infographic as jinfo
from tpuvc.eval import metrics as jmetrics
from tpuvc.eval import runner as jrunner
from tpuvc.gop import scheduler as jsched
from tpuvc.gop.order import gop_coding_table as jtable
from tpuvc_torch.eval import infographic as tinfo
from tpuvc_torch.eval import metrics as tmetrics
from tpuvc_torch.eval import runner as trunner
from tpuvc_torch.gop import scheduler as tsched
from tpuvc_torch.gop.order import gop_coding_table as ttable
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("shape, noise", [((1, 192, 192, 3), 0.1), ((2, 181, 177, 3), 0.02)])
def test_msssim_matches_tpuvc(shape, noise):
    """Even and odd sides (the edge padding before each 2x2 pool)."""
    rng = np.random.default_rng(shape[1])
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)
    ref = float(jmetrics.msssim(jnp.asarray(a), jnp.asarray(b)))
    out = float(tmetrics.msssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert 0.0 < ref < 1.0
    assert abs(out - ref) <= 1e-5
    assert float(tmetrics.msssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0)


def _ledgers(extra=()):
    rng = np.random.default_rng(0)
    j, t = jinfo.TestInfographic(extra), tinfo.TestInfographic(extra)
    for level in (1, 0):
        for video in ("beauty", "a,b", "jockey"):
            for f in range(9):
                row = (video, level, f, "I" if f % 4 == 0 else "B",
                       30 + 3 * rng.standard_normal(), 1e4 * rng.random(), 64 * 48)
                kw = {e: float(rng.random()) for e in extra}
                j.update(*row, **kw)
                t.update(*row, **kw)
    return j, t


@pytest.mark.parametrize("extra", [(), ("msssim",)])
def test_infographic_matches_tpuvc(tmp_path, extra):
    j, t = _ledgers(extra)
    assert t.columns == j.columns
    assert t.rows == j.dataframe().to_dict("records")
    for agg in ("per_level", "per_video", "per_frame_type"):
        assert getattr(t, agg)() == getattr(j, agg)().to_dict("records"), agg
    out = t.results_csv(tmp_path / "port.csv")
    ref = j.results_csv(tmp_path / "ref.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    assert out == ref.to_dict("records")


class _Recorder:
    """A deterministic inter_fn for both packages: x_hat is a fixed blend of
    the inputs, sizes depend on the frame indices; every call is logged."""

    def __init__(self, cat):
        self.calls, self.cat = [], cat

    def __call__(self, ref1, ref2, xcur, idxs, refs):
        self.calls.append((tuple(idxs), tuple(tuple(r) for r in refs), tuple(xcur.shape)))
        x_hat = 0.25 * ref1 + 0.25 * ref2 + 0.5 * xcur + 0.3
        sizes = self.cat([100.0 * i + 7.0 * a + b for i, (a, b) in zip(idxs, refs)])
        return x_hat, sizes


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((1, 8, 8, 3), dtype=np.float32) for _ in range(n)]


@pytest.mark.parametrize("max_batch", [None, 1, 3])
def test_code_gop_batched_matches_tpuvc(max_batch):
    frames = _frames(9)
    jf, tf = [jnp.asarray(f) for f in frames], [torch.from_numpy(f) for f in frames]
    jrec = _Recorder(lambda v: jnp.asarray(v, jnp.float32))
    trec = _Recorder(lambda v: torch.tensor(v, dtype=torch.float32))
    jsrc, tsrc = {}, {}
    jdec, jsizes = jsched.code_gop_batched(jf, {0: jf[0], 8: jf[8]}, jtable(8), jrec,
                                           max_batch=max_batch, sources=jsrc)
    tdec, tsizes = tsched.code_gop_batched(tf, {0: tf[0], 8: tf[8]}, ttable(8), trec,
                                           max_batch=max_batch, sources=tsrc)
    assert trec.calls == jrec.calls
    assert list(tsizes.items()) == list(jsizes.items())
    assert sorted(tdec) == sorted(jdec) == list(range(9))
    for f in jdec:
        np.testing.assert_array_equal(tdec[f].numpy(), np.asarray(jdec[f]))
    assert sorted(tsrc) == sorted(jsrc)


@pytest.mark.parametrize("max_batch", [None, 2, 3])
def test_code_gops_batched_matches_tpuvc(max_batch):
    """Three GOP-4 windows coded together: each level at batch 3 x width."""
    frames = _frames(13, seed=1)
    jf, tf = [jnp.asarray(f) for f in frames], [torch.from_numpy(f) for f in frames]
    starts = [0, 4, 8]
    jrec = _Recorder(lambda v: jnp.asarray(v, jnp.float32))
    trec = _Recorder(lambda v: torch.tensor(v, dtype=torch.float32))
    jdec, jsizes = jsched.code_gops_batched(jf, {b: jf[b] for b in (0, 4, 8, 12)}, jtable(4),
                                            jrec, starts, max_batch=max_batch)
    tdec, tsizes = tsched.code_gops_batched(tf, {b: tf[b] for b in (0, 4, 8, 12)}, ttable(4),
                                            trec, starts, max_batch=max_batch)
    assert trec.calls == jrec.calls
    assert list(tsizes.items()) == list(jsizes.items())
    assert sorted(tdec) == sorted(jdec) == list(range(13))
    for f in jdec:
        np.testing.assert_array_equal(tdec[f].numpy(), np.asarray(jdec[f]))


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """Small LHBDC and ELIC on the same seeded weights in both packages."""
    from tpuvc.models.elic import ELIC as JELIC
    from tpuvc.models.lhbdc import LHBDC as JLHBDC
    from tpuvc_torch.models.elic import ELIC
    from tpuvc_torch.models.lhbdc import LHBDC

    lhbdc, elic = write_sequence_checkpoints(tmp_path_factory.mktemp("weights"))
    intra, inter = ELIC(N=16, M=24, groups=(4, 4, 16)), LHBDC(N=32)
    intra.load_state_dict(params_from_jax(elic), strict=True)
    inter.load_state_dict(params_from_jax(lhbdc), strict=True)
    return {
        "tpuvc": ((JELIC(N=16, M=24, groups=(4, 4, 16)), elic), (JLHBDC(N=32), lhbdc)),
        "port": (intra.eval(), inter.eval()),
    }


def _cfg():
    from tpuvc_torch.config import TestConfig

    cfg = TestConfig()
    cfg.model.family = "lhbdc"
    return cfg


def _sequence(n, size=64):
    from tpuvc_torch.data.uvg import SyntheticSequence

    return SyntheticSequence(n_frames=n, h=size, w=size)


def _check(port, ref, prows, jrows):
    (pp, ps), (jp, js) = port, ref
    np.testing.assert_allclose(pp, jp, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ps, js, rtol=1e-5)
    assert [(r["frame_num"], r["type"]) for r in prows] == [(r["frame_num"], r["type"])
                                                            for r in jrows]
    for p, j in zip(prows, jrows):
        assert abs(p["psnr"] - j["psnr"]) <= 1e-4
        assert p["size"] == pytest.approx(j["size"], rel=1e-5)
        if "msssim" in j:
            assert abs(p["msssim"] - j["msssim"]) <= 1e-5


def test_eval_sequence_matches_tpuvc(packs):
    from tpuvc.cli import test as jtest
    from tpuvc.config import TestConfig as JConfig
    from tpuvc_torch.cli import test as ttest
    from tpuvc_torch.gop.order import sequence_order_from_table

    frames = _sequence(9)
    order, typ = sequence_order_from_table(4, len(frames))
    jcfg = JConfig()
    jcfg.model.family = "lhbdc"
    (jintra, jv_i), (jinter, jv_b) = packs["tpuvc"]
    jfns = jtest.make_frame_fns(jcfg, (jintra, jv_i), (jinter, jv_b), 0)
    tfns = ttest.make_frame_fns(_cfg(), *packs["port"], 0)
    jl, tl = jinfo.TestInfographic(), tinfo.TestInfographic()
    ref = jrunner.eval_sequence([jnp.asarray(frames[i]) for i in range(9)], order, typ, *jfns,
                                crop_hw=(64, 64), video="s", info=jl)
    with torch.inference_mode():
        out = trunner.eval_sequence([torch.from_numpy(frames[i]) for i in range(9)], order, typ,
                                    *tfns, crop_hw=(64, 64), video="s", info=tl)
    _check(out, ref, tl.rows, jl.dataframe().to_dict("records"))
    assert trunner.summarize(*out, (64, 64)) == pytest.approx(jrunner.summarize(*ref, (64, 64)),
                                                               rel=1e-5)


@pytest.mark.parametrize("window_gops, msssim", [(1, True), (2, False)])
def test_eval_sequence_batched_matches_tpuvc(packs, window_gops, msssim):
    """One GOP per window at 176x176 with MS-SSIM (each level one forward),
    and 2-GOP windows at 64x64 (cross-GOP batches, capped at 2)."""
    from tpuvc.cli import test as jtest
    from tpuvc.config import TestConfig as JConfig
    from tpuvc_torch.cli import test as ttest

    size = 176 if msssim else 64
    frames = _sequence(10, size)  # one frame past the last full GOP
    jcfg = JConfig()
    jcfg.model.family = "lhbdc"
    (jintra, jv_i), (jinter, jv_b) = packs["tpuvc"]
    jintra_fn, _ = jtest.make_frame_fns(jcfg, (jintra, jv_i),
                                        (jinter, jv_b), 0)
    jinter_b = jtest.make_batched_inter_fn(jcfg, (jinter, jv_b), 0, 4)
    tintra_fn, _ = ttest.make_frame_fns(_cfg(), *packs["port"], 0)
    tinter_b = ttest.make_batched_inter_fn(_cfg(), packs["port"][1], 0, 4)
    kw = dict(crop_hw=(size, size), video="s", max_batch=2, compute_msssim=msssim,
              window_gops=window_gops)
    jl = jinfo.TestInfographic(("msssim",) if msssim else ())
    tl = tinfo.TestInfographic(("msssim",) if msssim else ())
    ref = jrunner.eval_sequence_batched([jnp.asarray(frames[i]) for i in range(10)], 10, 4,
                                        jintra_fn, jinter_b, info=jl, **kw)
    with torch.inference_mode():
        out = trunner.eval_sequence_batched([torch.from_numpy(frames[i]) for i in range(10)], 10,
                                            4, tintra_fn, tinter_b, info=tl, **kw)
    assert len(out[0]) == 9  # the 2-GOP prefix
    _check(out, ref, tl.rows, jl.dataframe().to_dict("records"))


def test_config_copy_matches_tpuvc(tmp_path):
    """The port's config.py is a copy: the same fields and defaults, the
    same override parsing."""
    import dataclasses

    from tpuvc import config as jconfig
    from tpuvc_torch import config as tconfig

    for name in ("TestConfig", "TrainConfig", "DatasetConfig", "ModelConfig"):
        assert (dataclasses.asdict(getattr(tconfig, name)())
                == dataclasses.asdict(getattr(jconfig, name)())), name
    overrides = ["model.family=lhbdc", "levels=(0, 2)", "dataset.sequences={'a': 3}",
                 "output_dir=/x/y", "max_batch=4", "eval_msssim=True", "seed=abc"]
    assert (dataclasses.asdict(tconfig.apply_overrides(tconfig.TestConfig(), overrides))
            == dataclasses.asdict(jconfig.apply_overrides(jconfig.TestConfig(), overrides)))
    with pytest.raises(ValueError, match="bad override"):
        tconfig.apply_overrides(tconfig.TestConfig(), ["no_equals_sign"])
