"""tpuvc_torch.ops against tpuvc.ops on the CPU: padding, resampling, the
compute-dtype policy, the checkerboard masks, and the warp's plain version
in all compat modes.

Inputs come from a numpy seed and go through both packages. Tolerances:
layout ops and padding are exact; resampling is one small matrix product per
axis in both (<= 1e-6); the warp is <= 1e-5 (ROADMAP's kernel bar; the two
agree to float32 rounding of the blend).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvc.ops import checkerboard as jck
from tpuvc.ops import pad as jpad
from tpuvc.ops import resample as jres
from tpuvc.ops.warp import warp as jwarp
from tpuvc.ops.warp_pallas import _warp_xla
from tpuvc_torch.ops import checkerboard as tck
from tpuvc_torch.ops import pad as tpad
from tpuvc_torch.ops import precision
from tpuvc_torch.ops import resample as tres
from tpuvc_torch.ops.warp import warp, warp_plain

torch.set_num_threads(1)


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("mode", ["reflect", "edge", "constant"])
@pytest.mark.parametrize("hw", [(16, 16), (5, 13), (64, 64), (63, 2)])
def test_pad_to_multiple_matches_tpuvc(mode, hw):
    x = _rand((2, *hw, 3))
    ref, size = jpad.pad_to_multiple(jnp.asarray(x), 64, mode=mode)
    out, tsize = tpad.pad_to_multiple(torch.from_numpy(x), 64, mode=mode)
    assert tsize == size
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tpad.unpad(out, size).numpy(), np.asarray(jpad.unpad(ref, size))
    )


@pytest.mark.parametrize("hw", [(4, 4), (5, 7), (17, 30)])
def test_checkerboard_masks_match_tpuvc(hw):
    x = _rand((2, *hw, 3))
    np.testing.assert_array_equal(tck.anchor_mask(*hw).numpy(), np.asarray(jck.anchor_mask(*hw)))
    for name in ("keep_anchor", "keep_non_anchor"):
        np.testing.assert_array_equal(
            getattr(tck, name)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jck, name)(jnp.asarray(x))),
        )
    np.testing.assert_array_equal(tck.checkerboard_kernel_mask(5), jck.checkerboard_kernel_mask(5))


def test_avg_pool_matches_tpuvc():
    x = _rand((2, 16, 24, 5))
    np.testing.assert_allclose(
        tres.avg_pool2d(torch.from_numpy(x), 4).numpy(),
        np.asarray(jres.avg_pool2d(jnp.asarray(x), 4)), atol=1e-6,
    )


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("out_hw", [(34, 60), (8, 12), (17, 24)])
def test_bilinear_resize_matches_tpuvc(align, out_hw):
    x = _rand((2, 17, 30, 3))
    np.testing.assert_allclose(
        tres.bilinear_resize(torch.from_numpy(x), *out_hw, align_corners=align).numpy(),
        np.asarray(jres.bilinear_resize(jnp.asarray(x), *out_hw, align_corners=align)),
        atol=1e-6,
    )


def test_flow_upsamplers_match_tpuvc():
    f = _rand((2, 9, 15, 2), scale=3.0)
    np.testing.assert_allclose(
        tres.upsample2x_flow(torch.from_numpy(f)).numpy(),
        np.asarray(jres.upsample2x_flow(jnp.asarray(f))), atol=1e-5,
    )
    np.testing.assert_allclose(
        tres.upsample_flow(torch.from_numpy(f), 4).numpy(),
        np.asarray(jres.upsample_flow(jnp.asarray(f), 4)), atol=1e-5,
    )


def test_pixel_shuffle_matches_tpuvc():
    x = _rand((2, 5, 7, 12))
    np.testing.assert_array_equal(
        tres.pixel_shuffle(torch.from_numpy(x), 2).numpy(),
        np.asarray(jres.pixel_shuffle(jnp.asarray(x), 2)),
    )


def test_precision_policy_is_a_context():
    assert precision.compute_dtype() is None
    with precision.mixed_precision():
        assert precision.compute_dtype() is torch.bfloat16
        with precision.policy_from_name("f32"):
            assert precision.compute_dtype() is None
        assert precision.compute_dtype() is torch.bfloat16
    assert precision.compute_dtype() is None
    with pytest.raises(ValueError):
        precision.policy_from_name("float16")


def _warp_inputs(shape, scale, seed):
    B, H, W, C = shape
    rng = np.random.default_rng(seed)
    img = rng.random(shape, dtype=np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = np.stack([3 * np.sin(yy / 5.0), 2 * np.cos(xx / 7.0)], -1)
    flow = smooth[None] + scale * rng.standard_normal((B, H, W, 2)).astype(np.float32)
    return img, flow.astype(np.float32)


WARP_CASES = [
    ((2, 32, 48, 3), 2.0),   # the codec's frames
    ((1, 37, 53, 48), 3.0),  # DMC context width, unaligned H/W
    ((1, 20, 24, 1), 40.0),  # far out of frame: border / zero ring
    ((3, 34, 60, 3), 1.0),   # SPyNet's coarsest 1080p level
]


@pytest.mark.parametrize("compat", ["exact", "lhbdc", "flexrate"])
@pytest.mark.parametrize("shape,scale", WARP_CASES)
def test_warp_plain_matches_tpuvc_warp(compat, shape, scale):
    img, flow = _warp_inputs(shape, scale, seed=1)
    ref = np.asarray(jwarp(jnp.asarray(img), jnp.asarray(flow), compat=compat))
    out = warp_plain(torch.from_numpy(img), torch.from_numpy(flow), compat)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # On a CPU tensor the dispatcher runs exactly the plain version.
    disp = warp(torch.from_numpy(img), torch.from_numpy(flow), compat)
    assert torch.equal(disp, out)


@pytest.mark.parametrize("compat,sx", [("exact", None), ("lhbdc", "lhbdc")])
@pytest.mark.parametrize("shape,scale", WARP_CASES[:2])
def test_warp_plain_matches_warp_xla(compat, sx, shape, scale):
    img, flow = _warp_inputs(shape, scale, seed=2)
    B, H, W, C = shape
    sxy = (W / (W - 1.0), H / (H - 1.0)) if sx else (1.0, 1.0)
    ref = np.asarray(_warp_xla(jnp.asarray(img), jnp.asarray(flow), *sxy))
    out = warp_plain(torch.from_numpy(img), torch.from_numpy(flow), compat)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("compat", ["lhbdc", "flexrate"])
def test_warp_gradient_matches_tpuvc(compat):
    """The kernel's backward is autograd of the plain version; on the CPU
    that is what runs, and it matches JAX's gradient of tpuvc's warp."""
    img, flow = _warp_inputs((1, 16, 20, 3), 1.5, seed=3)
    g = np.random.default_rng(4).random(img.shape, dtype=np.float32)

    def loss(i, f):
        return jnp.sum(jwarp(i, f, compat=compat) * g)

    ji, jf = jax.grad(loss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(flow))
    ti = torch.from_numpy(img).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_()
    (warp(ti, tf, compat) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(ji), atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf), atol=1e-4)
