"""The port's RD and per-frame plots (``eval/plots.py``) and the eval CLI's
``write_plots``, against tpuvc's ``_write_plots`` on the same rows."""

import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PNG = b"\x89PNG\r\n\x1a\n"


def test_rd_curve_writes_a_png(tmp_path):
    import matplotlib

    from tpuvc_torch.eval.plots import rd_curve

    path = rd_curve({"port": ([0.05, 0.1, 0.2], [33.0, 35.5, 37.9])},
                    str(tmp_path / "rd.png"), title="test")
    assert path == str(tmp_path / "rd.png")
    assert (tmp_path / "rd.png").read_bytes()[:8] == PNG
    assert matplotlib.get_backend().lower() == "agg"


def test_per_frame_figure_writes_a_png(tmp_path):
    from tpuvc_torch.eval.plots import per_frame_figure

    psnrs = list(30 + np.random.default_rng(0).random(17))
    path = per_frame_figure(psnrs, [4096.0 * (i + 1) for i in range(17)], 64 * 64,
                            str(tmp_path / "f.png"), title="seq level 0")
    assert (tmp_path / "f.png").read_bytes()[:8] == PNG and path.endswith("f.png")


def test_plots_name_matplotlib_when_it_is_missing(tmp_path, monkeypatch):
    from tpuvc_torch.eval import plots

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.require_matplotlib()
    with pytest.raises(ImportError, match="matplotlib"):
        plots.rd_curve({"port": ([0.1], [30.0])}, str(tmp_path / "rd.png"))
    assert not (tmp_path / "rd.png").exists()


def test_eval_cli_without_matplotlib_exits_naming_it(tmp_path, monkeypatch):
    from tpuvc_torch.cli import test as ttest

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib"):
        ttest.main(["--device", "cpu", "write_plots=true", f"output_dir={tmp_path}"])
    assert not (tmp_path / "results.csv").exists()


OVERRIDES = ["dataset.name=synthetic", 'dataset.sequences={"a": 5, "b": 5}', "dataset.gop=4",
             "dataset.width=64", "dataset.height=64", "model.family=lhbdc", "model.N=16",
             "levels=(0,1)"]


def _capture(monkeypatch, module):
    """Record the arguments of module's rd_curve / per_frame_figure, then
    draw as they would."""
    calls = []
    for name in ("rd_curve", "per_frame_figure"):
        fn = getattr(module, name)

        def record(*args, _fn=fn, _name=name, **kw):
            calls.append((_name, args, kw))
            return _fn(*args, **kw)

        monkeypatch.setattr(module, name, record)
    return calls


def test_eval_cli_write_plots_matches_tpuvc(tmp_path, monkeypatch, capsys):
    """The port's eval CLI with write_plots=true, then tpuvc's _write_plots
    on the same rows: the same files, drawn from the same numbers."""
    import tpuvc.eval.plots as jplots
    import tpuvc_torch.eval.plots as tplots
    from tpuvc import config as jconfig
    from tpuvc.cli.test import _write_plots
    from tpuvc.eval.infographic import TestInfographic as JInfo
    from tpuvc_torch.cli import test as ttest

    tcalls = _capture(monkeypatch, tplots)
    out = ttest.main(["--device", "cpu", "write_plots=true",
                      f"output_dir={tmp_path / 'port'}"] + OVERRIDES)
    printed = capsys.readouterr().out
    port_pngs = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert port_pngs == ["a_l0_frames.png", "a_l1_frames.png", "b_l0_frames.png",
                         "b_l1_frames.png", "rd_curve.png"]
    for name in port_pngs:
        assert (tmp_path / "port" / name).read_bytes()[:8] == PNG
        assert f"wrote {tmp_path / 'port' / name}" in printed

    jinfo = JInfo()
    for r in out["info"].rows:
        jinfo.update(r["video"], r["level"], r["frame_num"], r["type"], r["psnr"], r["size"],
                     r["pixels"])
    jcfg = jconfig.apply_overrides(jconfig.TestConfig(), OVERRIDES + [
        f"output_dir={tmp_path / 'tpuvc'}"])
    (tmp_path / "tpuvc").mkdir()
    jcalls = _capture(monkeypatch, jplots)
    _write_plots(jcfg, jinfo)
    assert sorted(p.name for p in (tmp_path / "tpuvc").glob("*.png")) == port_pngs

    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    for (name, targs, tkw), (_, jargs, jkw) in zip(tcalls, jcalls):
        assert tkw.get("title") == jkw.get("title")
        if name == "rd_curve":
            (fam, (tb, tp)), = targs[0].items()
            (jfam, (jb, jp)), = jargs[0].items()
            assert fam == jfam == "lhbdc"
            np.testing.assert_allclose(tb, jb, rtol=1e-12)
            np.testing.assert_allclose(tp, jp, rtol=1e-12)
        else:
            np.testing.assert_array_equal(targs[0], jargs[0])  # PSNR per frame
            np.testing.assert_array_equal(targs[1], jargs[1])  # bits per frame
            assert targs[2] == jargs[2]  # pixels
        assert str(targs[-1]).replace("port", "tpuvc") == str(jargs[-1])
