"""tpuvc_torch's exported helpers against tpuvc's: the ``ops`` package's
names, ``pixel_unshuffle``, ``padded_size``, ``warp_and_blend`` and the
native pmf -> CDF quantizer, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuvc.ops as jops
import tpuvc_torch.ops as tops

torch.set_num_threads(1)


@pytest.mark.parametrize("name", jops.__all__)
def test_ops_exports_tpuvc_names(name):
    assert name in tops.__all__
    assert callable(getattr(tops, name))


@pytest.mark.parametrize("compat", ["exact", "lhbdc", "flexrate"])
def test_ops_warp_export_computes_tpuvcs_warp(compat):
    """``tpuvc_torch.ops.warp`` is the warp module (its kernel wrapper and
    counts stay reachable) and, called, the warp function, as tpuvc's
    ``ops.warp`` export is."""
    from tpuvc_torch.ops import warp

    rng = np.random.default_rng(1)
    img = rng.random((1, 16, 24, 3), dtype=np.float32)
    flow = (3.0 * rng.standard_normal((1, 16, 24, 2))).astype(np.float32)
    got = warp(torch.from_numpy(img), torch.from_numpy(flow), compat)
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.warp(jnp.asarray(img),
                               jnp.asarray(flow), compat=compat)), atol=2e-5, rtol=0)
    assert torch.equal(got, warp.warp(torch.from_numpy(img), torch.from_numpy(flow), compat))
    assert hasattr(warp, "warp_kernel") and hasattr(warp, "warp_plain")


def test_ops_exports_the_same_list():
    assert tops.__all__ == jops.__all__


@pytest.mark.parametrize("shape,r", [((1, 8, 12, 3), 2), ((2, 3, 12, 6, 5), 3), ((4, 4, 7), 4)])
def test_pixel_unshuffle_matches_tpuvc(shape, r):
    from tpuvc.ops.resample import pixel_unshuffle as jpu

    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    got = tops.pixel_unshuffle(torch.from_numpy(x), r)
    want = np.asarray(jpu(jnp.asarray(x), r))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tops.pixel_shuffle(got, r).numpy(), x)


@pytest.mark.parametrize("h,w,m", [(1088, 1920, 64), (1080, 1920, 64), (64, 64, 64),
                                   (1, 1, 64), (100, 150, 16), (512, 768, 64)])
def test_padded_size_matches_tpuvc(h, w, m):
    from tpuvc.ops.pad import padded_size as jps
    from tpuvc_torch.ops.pad import padded_size

    assert padded_size(h, w, m) == jps(h, w, m)
    x = torch.zeros(1, h, w, 3)
    assert tuple(tops.pad_to_multiple(x, m)[0].shape[1:3]) == padded_size(h, w, m)


@pytest.mark.parametrize("compat", ["exact", "lhbdc", "flexrate"])
def test_warp_and_blend_matches_tpuvc(compat):
    from tpuvc.ops.warp import warp_and_blend as jwb
    from tpuvc_torch.ops.warp import warp_and_blend, warp_plain

    rng = np.random.default_rng(3)
    B, H, W, C = 2, 24, 40, 3
    img_fw, img_bw = (rng.random((B, H, W, C), dtype=np.float32) for _ in range(2))
    flow_fw, flow_bw = ((4.0 * rng.standard_normal((B, H, W, 2))).astype(np.float32)
                        for _ in range(2))
    mask = rng.random((B, H, W, 1), dtype=np.float32)
    args = (img_fw, flow_fw, img_bw, flow_bw, mask)
    got = warp_and_blend(*map(torch.from_numpy, args), compat=compat)
    want = np.asarray(jwb(*map(jnp.asarray, args), compat=compat))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    t = [torch.from_numpy(a) for a in args]
    plain = t[4] * warp_plain(t[0], t[1], compat) + (1.0 - t[4]) * warp_plain(t[2], t[3], compat)
    assert torch.equal(got, plain)


def _pmfs(seed=0, n_trials=50):
    rng = np.random.default_rng(seed)
    for trial in range(n_trials):
        n = int(rng.integers(1, 300))
        pmf = rng.random(n) ** 3
        if trial % 3 == 0:
            pmf[rng.integers(0, n)] = 0.0
        yield pmf


def test_pmf_to_quantized_cdf_native_matches_numpy_and_tpuvc():
    from tpuvc.coder.rans import pmf_to_quantized_cdf_native as jnative
    from tpuvc_torch.coder.rans import pmf_to_quantized_cdf_native
    from tpuvc_torch.entropy.cdf import pmf_to_quantized_cdf

    for pmf in _pmfs():
        got = pmf_to_quantized_cdf_native(pmf)
        assert got.dtype == np.int32 and got[-1] == 1 << 16
        np.testing.assert_array_equal(got, pmf_to_quantized_cdf(pmf))
        np.testing.assert_array_equal(got, jnative(pmf))


@pytest.mark.parametrize("pmf,precision", [
    (np.zeros(5), 16),                 # no mass: a uniform CDF
    (np.array([1.0] + [1e-12] * 40), 6),  # a surplus to take back
    (np.array([0.7, 0.2, 0.1]), 4),
])
def test_pmf_to_quantized_cdf_native_edge_cases(pmf, precision):
    from tpuvc.coder.rans import pmf_to_quantized_cdf_native as jnative
    from tpuvc_torch.coder.rans import pmf_to_quantized_cdf_native
    from tpuvc_torch.entropy.cdf import pmf_to_quantized_cdf

    got = pmf_to_quantized_cdf_native(pmf, precision)
    np.testing.assert_array_equal(got, pmf_to_quantized_cdf(pmf, precision))
    np.testing.assert_array_equal(got, jnative(pmf, precision))


def test_pmf_to_quantized_cdf_native_refuses_malformed_input():
    from tpuvc_torch.coder.rans import pmf_to_quantized_cdf_native

    for pmf, precision in ((np.array([0.5, np.nan]), 16), (np.ones(5), 2), (np.ones(3), 0)):
        with pytest.raises(ValueError):
            pmf_to_quantized_cdf_native(pmf, precision)
