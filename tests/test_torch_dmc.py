"""tpuvc_torch.models.dmc (the DMC P-frame codec), entropy.laplace, the
antialiased resize and the P-frame containers against tpuvc on the CPU.

The model runs at tpuvc's tests/test_dmc.py size (feat 16, N 32) on 128x128
frames, so the fractional ratio 1.5 really down-samples (to 80x80, edge
padded to 128 for SPyNet), on the same seeded parameters in both packages
(tests/torch_params_common.py, carried over by ``params_from_jax``), the
gains drawn around 1 so that the rate levels differ. Two frames are chained
through each package's DPB. Bars: x_hat 2e-5 absolute; bits 1e-6 relative
on float64 sums of each package's likelihoods (ROADMAP.md C); the resize
1e-6 absolute; the partition ops and the Laplace tables exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import filled_params
from tpuvc.coder import container as jcont
from tpuvc.entropy.laplace import LaplaceConditional as JLaplace
from tpuvc.models import dmc as jd
from tpuvc_torch.coder import container as tcont
from tpuvc_torch.entropy.laplace import LaplaceConditional as TLaplace
from tpuvc_torch.models import dmc as td
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

KW = dict(feat=16, N=32)


@pytest.mark.parametrize("ratio", [1.25, 1.5, 2.0, 3.0, 4.0, 8.75])
@pytest.mark.parametrize("shape", [(1, 67, 93, 3), (2, 131, 75, 5)])
def test_resize_antialias_matches_jax_image(ratio, shape):
    """jax.image.resize's antialiased linear weights (a triangle widened by
    the down-sampling factor), on odd sizes, at DMC's size rule."""
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    H, W = shape[1:3]
    h = max(int(round(H / ratio)) // 8 * 8, 8)
    w = max(int(round(W / ratio)) // 8 * 8, 8)
    ref = np.asarray(jd.resize_antialias(jnp.asarray(x), h, w))
    out = td.resize_antialias(torch.from_numpy(x), h, w).numpy()
    assert out.shape == ref.shape == (shape[0], h, w, shape[3])
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_resize_antialias_keeps_an_unchanged_axis():
    x = np.random.default_rng(1).random((1, 64, 97, 3), dtype=np.float32)
    ref = np.asarray(jd.resize_antialias(jnp.asarray(x), 64, 48))
    out = td.resize_antialias(torch.from_numpy(x), 64, 48).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    assert td.resize_antialias(torch.from_numpy(x), 64, 97).numpy().tobytes() == x.tobytes()


@pytest.mark.parametrize("k", range(4))
def test_part_ops_match_tpuvc(k):
    rng = np.random.default_rng(k)
    full = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    vals = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    assert np.array_equal(td.part_mask(6, 10, 8, k).numpy(), np.asarray(jd.part_mask(6, 10, 8, k)))
    assert np.array_equal(td.part_squeeze(torch.from_numpy(full), k).numpy(),
                          np.asarray(jd.part_squeeze(jnp.asarray(full), k)))
    t_full = torch.from_numpy(full)
    out = td.part_scatter(t_full, torch.from_numpy(vals), k)
    assert np.array_equal(out.numpy(), np.asarray(jd.part_scatter(jnp.asarray(full),
                                                                  jnp.asarray(vals), k)))
    assert np.array_equal(t_full.numpy(), full)  # a new tensor; the input is untouched
    # the four parts tile the latent exactly once
    masks = sum(td.part_mask(6, 10, 8, j) for j in range(4))
    assert torch.equal(masks, torch.ones(6, 10, 8))


def test_q_step_matches_tpuvc():
    raw = np.linspace(-5, 5, 101, dtype=np.float32)
    np.testing.assert_allclose(td._q_step(torch.from_numpy(raw)).numpy(),
                               np.asarray(jd._q_step(jnp.asarray(raw))), rtol=1e-6, atol=0)


def test_laplace_likelihood_and_indexes_match_tpuvc():
    """Likelihoods within 1e-6 relative, or one float32 step below 1.0
    (2**-24) absolute: at wide scales both packages take the likelihood as
    a difference of two CDF values near 0.5 and 1, and their float32 exp
    (XLA's and PyTorch's) may round a CDF value one step apart."""
    rng = np.random.default_rng(3)
    y = np.round(4 * rng.standard_normal((2, 8, 8, 16))).astype(np.float32)
    scales = np.exp(rng.uniform(-4, 6, y.shape)).astype(np.float32)
    means = rng.standard_normal(y.shape).astype(np.float32)
    j, t = JLaplace(), TLaplace()
    ref = np.asarray(j.likelihood(jnp.asarray(y), jnp.asarray(scales), jnp.asarray(means)))
    out = t.likelihood(*map(torch.from_numpy, (y, scales, means))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=2**-24)
    assert np.array_equal(t.build_indexes(torch.from_numpy(scales)).numpy(),
                          np.asarray(j.build_indexes(jnp.asarray(scales))))


def test_laplace_tables_match_tpuvc():
    ref, out = JLaplace().build_tables(), TLaplace().build_tables()
    for k in ("cdfs", "cdf_lengths", "offsets"):
        assert np.array_equal(getattr(out, k), getattr(ref, k)), k


def _q_vec(levels=4, n=8, seed=5):
    return np.exp(0.3 * np.random.default_rng(seed).standard_normal((levels, n))).astype(np.float32)


@pytest.mark.parametrize("q", [0.0, 0.3, 1.0, 1.5, 2.7, 3.0, 4.2, -1.0])
def test_gain_interpolation_matches_tpuvc(q):
    g = _q_vec()
    g[1] *= -1.0  # |g| is what counts
    jc = jd._FourPartCoder(N=8)
    ref = jc._interp(jnp.asarray(g), q)
    tc = td._FourPartCoder(N=8)
    out = tc._interp(torch.from_numpy(g), q)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-6, atol=0)


@pytest.fixture(scope="module")
def pair():
    jm = jd.PFrameDMC(**KW)
    x = jnp.zeros((1, 64, 64, 3))
    dpb = {"ref_frame": x, "ref_feature": None, "ref_down_ratio": 1.0}
    v = filled_params(lambda: jm.init(jax.random.key(0), x, dpb, 1.0, "dequantize"), seed=0)
    tm = td.PFrameDMC(**KW)
    tm.load_state_dict(params_from_jax(v), strict=True)
    return jm, v, tm.eval()


def _frames(n=3, hw=128, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((1, hw, hw, 3), dtype=np.float32)
    drift = 0.03 * rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    return np.clip(base + np.cumsum(drift, axis=0), 0, 1)


def _bits64(liks):
    return sum(
        float(np.sum(-np.log2(np.maximum(np.asarray(p, np.float64), 1e-9)))) for p in liks
    )


@pytest.mark.parametrize("ratio, q", [(1.0, 0.0), (1.5, 1.3)])
def test_dmc_forward_matches_tpuvc(pair, ratio, q):
    """Two P-frames chained through each package's DPB (the second uses the
    propagated feature, MV feature and both temporal priors)."""
    jm, v, tm = pair
    xs = _frames(seed=int(10 * ratio))
    jdpb = {"ref_frame": jnp.asarray(xs[0:1]), "ref_feature": None, "ref_down_ratio": 1.0}
    tdpb = {"ref_frame": torch.from_numpy(xs[0:1]), "ref_feature": None, "ref_down_ratio": 1.0}
    for i in (1, 2):
        ref, state = jm.apply(
            v, jnp.asarray(xs[i : i + 1]), jdpb, ratio, "dequantize", q=q,
            capture_intermediates=lambda m, n: isinstance(m, jd._FourPartCoder) and n == "__call__",
        )
        ref_liks = [p for c in ("mv_coder", "y_coder")
                    for p in state["intermediates"][c]["__call__"][0][1].values()]
        liks = []
        hooks = [getattr(tm, c).register_forward_hook(lambda m, a, o: liks.extend(o[1].values()))
                 for c in ("mv_coder", "y_coder")]
        try:
            with torch.no_grad():
                out = tm(torch.from_numpy(xs[i : i + 1]), tdpb, ratio, "dequantize", q=q)
        finally:
            for h in hooks:
                h.remove()
        for k in ("x_hat", "warped"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=2e-5, rtol=0)
        assert len(liks) == len(ref_liks) == 4
        assert abs(_bits64(liks) / _bits64(ref_liks) - 1.0) <= 1e-6
        for k in ("ref_feature", "ref_mv_feature", "ref_y", "ref_mv_y"):
            assert out["dpb"][k].shape == ref["dpb"][k].shape
        assert out["dpb"]["ref_down_ratio"] == ratio
        jdpb, tdpb = ref["dpb"], out["dpb"]


@pytest.mark.parametrize("ratio", [1.0, 1.5])
def test_warp_prediction_matches_tpuvc(pair, ratio):
    jm, v, tm = pair
    xs = _frames(n=2, seed=3)
    ref = jm.apply(v, jnp.asarray(xs[1:2]), jnp.asarray(xs[0:1]), ratio,
                   method=jd.PFrameDMC.warp_prediction)
    with torch.no_grad():
        out = tm.warp_prediction(torch.from_numpy(xs[1:2]), torch.from_numpy(xs[0:1]), ratio)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_aux_loss_matches_tpuvc(pair):
    jm, v, tm = pair
    ref = float(jm.apply(v, method=jd.PFrameDMC.aux_loss))
    np.testing.assert_allclose(float(tm.aux_loss().detach()), ref, rtol=1e-5)


def test_noise_mode_draws_from_the_generator(pair):
    """``mode="noise"`` (training) needs an explicit generator and is
    reproducible from its seed; the rate is differentiable."""
    _, _, tm = pair
    xs = torch.from_numpy(_frames(n=2, hw=64, seed=4))
    dpb = {"ref_frame": xs[0:1], "ref_feature": None, "ref_down_ratio": 1.0}
    with pytest.raises(ValueError, match="Generator"):
        tm(xs[1:2], dpb, 1.0, "noise")
    a = tm(xs[1:2], dpb, 1.0, "noise", generator=torch.Generator().manual_seed(1))
    b = tm(xs[1:2], dpb, 1.0, "noise", generator=torch.Generator().manual_seed(1))
    assert torch.equal(a["x_hat"], b["x_hat"]) and torch.equal(a["bits"], b["bits"])
    a["rate"].backward()
    assert tm.mv_coder.h_a1.weight.grad is not None
    tm.zero_grad(set_to_none=True)


def test_seeded_weights_reproduce_and_start_gains_at_one():
    a = td.PFrameDMC(**KW, generator=torch.Generator().manual_seed(0))
    b = td.PFrameDMC(**KW, generator=torch.Generator().manual_seed(0))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for c in ("mv_coder", "y_coder"):
        assert torch.equal(sa[f"{c}.gain"], torch.ones(4, 32))
    assert float(sa["mv_out.weight"].abs().max()) > 0  # lecun-normal, not zero


PFRAME = dict(q_milli=1300, ratio_centi=125, z_shape=(4, 6),
              streams=[bytes([i]) * (3 * i) for i in range(10)])


def test_pframe_bitstream_bytes_match_tpuvc():
    blob = tcont.PFrameBitstream(**PFRAME).serialize()
    assert blob == jcont.PFrameBitstream(**PFRAME).serialize()
    back = tcont.PFrameBitstream.deserialize(blob)
    assert (back.q_milli, back.ratio_centi, back.z_shape, back.streams) == tuple(PFRAME.values())
    assert back.num_bytes == len(blob)


def test_psequence_bytes_match_tpuvc_both_ways():
    frames = [("I", b"intra" * 7), ("P", b""), ("P", b"p" * 300)]
    blob = tcont.PSequenceBitstream(width=1920, height=1080, frames=frames).serialize()
    assert blob == jcont.PSequenceBitstream(width=1920, height=1080, frames=frames).serialize()
    for cls in (tcont.PSequenceBitstream, jcont.PSequenceBitstream):
        back = cls.deserialize(blob)
        assert (back.width, back.height, back.frames) == (1920, 1080, frames)
    assert tcont.PSequenceBitstream.deserialize(blob).num_bytes == len(blob)
    with pytest.raises(ValueError, match="magic"):
        tcont.PSequenceBitstream.deserialize(b"TPV3" + blob[4:])
