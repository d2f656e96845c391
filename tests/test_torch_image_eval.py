"""The port's still-image (Kodak-style) eval against tpuvc's on the CPU:
the datasets array for array, ``eval_images``' rows, and the
``test_image`` CLI's rows from one full-width ELIC checkpoint (PSNR within
1e-4 dB, bits within 1e-5 relative)."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import filled_params

torch.set_num_threads(1)


@pytest.mark.parametrize("n,h,w,multiple", [(2, 100, 150, 64), (3, 64, 96, 64), (1, 37, 21, 16)])
def test_synthetic_images_match_tpuvc(n, h, w, multiple):
    from tpuvc.data.kodak import SyntheticImages as J
    from tpuvc_torch.data.kodak import SyntheticImages as P

    got, want = P(n=n, h=h, w=w, seed=3, multiple=multiple), J(n=n, h=h, w=w, seed=3,
                                                                 multiple=multiple)
    assert len(got) == len(want) == n
    for i in range(n):
        assert got[i].dtype == np.float32
        np.testing.assert_array_equal(got[i], want[i])
        assert got.size(i) == want.size(i) == (h, w)


def test_image_folder_matches_tpuvc(tmp_path):
    from tpuvc.data.kodak import ImageFolder as J
    from tpuvc_torch.data.frames import save_png
    from tpuvc_torch.data.kodak import ImageFolder as P

    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(80, 130), (512, 768), (768, 512)]):
        save_png(tmp_path / f"kodim{i:02d}.png", (rng.random((h, w, 3)) * 255).astype(np.uint8))
    got, want = P(str(tmp_path)), J(str(tmp_path))
    assert len(got) == len(want) == 3
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])
        assert got.size(i) == want.size(i)
    assert got[0].shape == (1, 128, 192, 3) and got.size(0) == (80, 130)


def _noisy_codec(seed):
    rng = np.random.default_rng(seed)

    def fn(x):
        noise = 0.03 * rng.standard_normal(x.shape).astype(np.float32)
        return x + noise, 1000.0 + float(np.abs(noise).sum())

    return fn


@pytest.mark.parametrize("codec", ["identity", "noisy"])
def test_eval_images_rows_match_tpuvc(codec):
    from tpuvc.data.kodak import SyntheticImages as JS
    from tpuvc.eval.image_runner import eval_images as jeval
    from tpuvc.eval.infographic import TestInfographic as JI
    from tpuvc_torch.data.kodak import SyntheticImages as PS
    from tpuvc_torch.eval.image_runner import eval_images as peval
    from tpuvc_torch.eval.infographic import TestInfographic as PI

    kw = dict(n=2, h=180, w=200, seed=1)
    msssim = codec == "noisy"
    cols = ("msssim",) if msssim else ()
    jinfo, pinfo = JI(extra_columns=cols), PI(extra_columns=cols)
    if codec == "identity":
        jfn = pfn = lambda x: (x, 128.0)
    else:
        jfn, pfn = _noisy_codec(4), _noisy_codec(4)
    jp, jb = jeval(JS(**kw), jfn, name="synth", level=1, info=jinfo, compute_msssim=msssim)
    # the port's codec hands back a tensor and a tensor bit count
    pp, pb = peval(PS(**kw), lambda x: tuple(map(torch.as_tensor, pfn(x))), name="synth",
                   level=1, info=pinfo, compute_msssim=msssim)
    np.testing.assert_allclose(pp, jp, atol=1e-4, rtol=0)
    np.testing.assert_allclose(pb, jb, rtol=1e-6)
    want = jinfo.dataframe().to_dict("records")
    assert len(pinfo.rows) == len(want) == 2
    for got, ref in zip(pinfo.rows, want):
        assert (got["video"], got["level"], got["frame_num"], got["type"], got["pixels"]) == (
            ref["video"], ref["level"], ref["frame_num"], ref["type"], ref["pixels"])
        assert got["psnr"] == pytest.approx(ref["psnr"], abs=1e-4)
        assert got["size"] == pytest.approx(ref["size"], rel=1e-6)
        if msssim:
            assert got["msssim"] == pytest.approx(ref["msssim"], abs=1e-5)
    if codec == "identity":
        np.testing.assert_allclose(pb, 128.0 / (180 * 200))


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_cli_rows_match_tpuvc(tmp_path, capsys):
    """Both packages' test_image CLIs on three 64x96 synthetic images, one
    level, from one full-width ELIC checkpoint written by tpuvc."""
    from tpuvc.cli.test_image import main as jmain
    from tpuvc.models.elic import ELIC
    from tpuvc.utils.checkpoint import save_checkpoint
    from tpuvc_torch.cli.test_image import main as pmain

    x = jnp.zeros((1, 64, 64, 3))
    params = filled_params(lambda: ELIC().init(jax.random.key(0), x, "dequantize"), seed=8)
    (tmp_path / "w" / "level_0").mkdir(parents=True)
    save_checkpoint(str(tmp_path / "w" / "level_0" / "latest.msgpack"), params)
    common = ["dataset.name=synthetic", "dataset.height=64", "dataset.width=96",
              "levels=(0,)", f"intra_weights={tmp_path / 'w'}"]
    jmain(common + [f"output_dir={tmp_path / 'j'}"])
    got = pmain(["--device", "cpu"] + common + [f"output_dir={tmp_path / 'p'}"])
    printed = capsys.readouterr().out
    assert f"level 0: loaded {tmp_path / 'w' / 'level_0' / 'latest.msgpack'}" in printed
    want = _rows(tmp_path / "j" / "results.csv")
    rows = _rows(tmp_path / "p" / "results.csv")
    assert len(rows) == len(want) == 1 and got["images"] == 3
    for r, ref in zip(rows, want):
        assert (r["level"], r["sequence"]) == (ref["level"], ref["sequence"])
        assert abs(float(r["psnr"]) - float(ref["psnr"])) <= 1e-4
        assert abs(float(r["bpp"]) / float(ref["bpp"]) - 1.0) <= 1e-5
        assert np.isfinite(float(r["psnr"])) and float(r["bpp"]) > 0
    assert f"0 synthetic {float(rows[0]['psnr']):.4f}" in printed


def test_cli_seeded_weights_run_every_level(tmp_path):
    """Without checkpoints each level runs on the seeded weights, and a
    level-specific checkpoint is taken only for its level."""
    from tpuvc_torch.cli.test_image import main as pmain

    out = pmain(["--device", "cpu", "dataset.name=synthetic", "dataset.height=64",
                 "dataset.width=64", "levels=(0,1)", f"intra_weights={tmp_path / 'none'}",
                 f"output_dir={tmp_path}"])
    assert sorted(out["levels"]) == [0, 1]
    assert out["levels"][0]["psnr"] == out["levels"][1]["psnr"]
    assert all(np.isfinite(v["bpp"]) and v["seconds"] > 0 for v in out["levels"].values())
    assert [r["level"] for r in out["results"]] == [0, 1]


def test_cli_defaults_to_cuda():
    from tpuvc_torch.cli.test_image import main as pmain

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pmain(["dataset.name=synthetic", "dataset.height=64", "dataset.width=64"])
