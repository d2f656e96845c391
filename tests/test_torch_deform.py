"""tpuvc_torch.ops.deform against tpuvc.ops.deform on the CPU.

``deform_plain`` (what the CUDA kernel is held to on the card) against
tpuvc's tap-unrolled XLA formulation ``_deform_taps(force_xla=True)``, with
offsets at integer taps, fractional offsets, samples on and around the frame
edge, and samples far outside it; one case against tpuvc's fused Pallas
kernel run in interpret mode, as tests/test_deform_pallas.py runs it; the
gradient the kernel's backward uses; and OffsetDiversity, the deform conv's
user, with its parameters carried over by ``params_from_jax``.

Inputs come from numpy seeds. Bar: 1e-5 absolute on O(1) outputs (the two
packages contract each tap's group channels in other summation orders);
the Pallas kernel bar is tests/test_deform_pallas.py's 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvc.models.offset_diversity import OffsetDiversity as JOffsetDiversity
from tpuvc.ops.deform import _deform_taps
from tpuvc.ops.deform_pallas import deform_sample_accum
from tpuvc_torch.models.offset_diversity import OffsetDiversity
from tpuvc_torch.ops.deform import deform_conv2d, deform_plain
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

K = 3
T = K * K


def _inputs(B, H, W, G, Cg, Og, spread, seed=0):
    """x, offsets (dy, dx per group and tap), masks, HWIO weight, bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, G * Cg)).astype(np.float32)
    shape = (B, H, W, G, T, 2)
    if spread == "zero":
        off = np.zeros(shape)
    elif spread == "fractional":
        yy, xx = np.mgrid[0:H, 0:W]
        smooth = np.stack([2.5 * np.sin(yy / 3.0), 2.5 * np.cos(xx / 4.0)], -1)
        off = smooth[None, :, :, None, None] + 0.7 * rng.standard_normal(shape)
    elif spread == "frame_edge":
        # Sample points on and around the frame's edge: -1, -0.5, W-0.5, W,
        # and the same rows, from every pixel (the tap base is added back).
        targets_x = rng.choice([-1.0, -0.5, 0.0, W - 1.0, W - 0.5, W, W + 0.25],
                               size=shape[:-1])
        targets_y = rng.choice([-1.0, -0.5, 0.0, H - 1.0, H - 0.5, H, -0.75],
                               size=shape[:-1])
        ky, kx = np.divmod(np.arange(T), K)
        yy, xx = np.mgrid[0:H, 0:W]
        dx = targets_x - xx[None, :, :, None, None] - (kx - 1)
        dy = targets_y - yy[None, :, :, None, None] - (ky - 1)
        off = np.stack([dy, dx], -1)
    else:  # far: mostly outside the frame
        off = 40.0 * rng.standard_normal(shape)
    off = off.reshape(B, H, W, G * T * 2).astype(np.float32)
    masks = rng.random((B, H, W, G * T), dtype=np.float32)
    weight = (rng.standard_normal((K, K, Cg, G * Og)) / np.sqrt(T * Cg)).astype(np.float32)
    bias = rng.standard_normal(G * Og).astype(np.float32)
    return x, off, masks, weight, bias


def _oihw(weight):
    return torch.from_numpy(np.ascontiguousarray(weight.transpose(3, 2, 0, 1)))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("Cg", [2, 8, 12])
@pytest.mark.parametrize("spread", ["zero", "fractional", "frame_edge", "far"])
def test_deform_plain_matches_tpuvc(spread, Cg, with_bias):
    G, Og = 2, 3
    x, off, masks, weight, bias = _inputs(2, 12, 16, G, Cg, Og, spread, seed=Cg)
    b = bias if with_bias else None
    ref = np.asarray(_deform_taps(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(masks), jnp.asarray(weight),
        None if b is None else jnp.asarray(b), G, K, fused=False, force_xla=True,
    ))
    tx, toff, tm = _t(x, off, masks)
    out = deform_plain(tx, toff, tm, _oihw(weight),
                       None if b is None else torch.from_numpy(b), G, K)
    assert out.shape == ref.shape == (2, 12, 16, G * Og)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # On a CPU tensor the dispatcher runs exactly the plain version.
    disp = deform_conv2d(tx, toff, tm, _oihw(weight),
                         None if b is None else torch.from_numpy(b), G, K)
    assert torch.equal(disp, out)


def test_deform_plain_without_masks_matches_tpuvc():
    x, off, _, weight, bias = _inputs(1, 10, 14, 2, 4, 2, "fractional", seed=5)
    ref = np.asarray(_deform_taps(
        jnp.asarray(x), jnp.asarray(off), None, jnp.asarray(weight),
        jnp.asarray(bias), 2, K, fused=False, force_xla=True,
    ))
    tx, toff, tb = _t(x, off, bias)
    out = deform_plain(tx, toff, None, _oihw(weight), tb, 2, K)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_deform_plain_matches_pallas_kernel_in_interpret_mode():
    """tpuvc's fused Pallas kernel (interpret mode) on the fused path's own
    operand layout: per-tap (dx, dy) flows with the tap base, masks and
    grouped weights, batch item b*G + g using weight group g."""
    B, H, W, G, Cg, Og = 1, 16, 24, 2, 4, 3
    x, off, masks, weight, _ = _inputs(B, H, W, G, Cg, Og, "fractional", seed=7)
    xg = x.reshape(B, H, W, G, Cg).transpose(0, 3, 1, 2, 4).reshape(B * G, H, W, Cg)
    o = off.reshape(B, H, W, G, T, 2).transpose(0, 3, 4, 1, 2, 5).reshape(B * G, T, H, W, 2)
    ky, kx = np.divmod(np.arange(T), K)
    flows = o[..., ::-1] + np.stack([kx - 1, ky - 1], -1)[None, :, None, None, :]
    m = masks.reshape(B, H, W, G, T).transpose(0, 3, 4, 1, 2).reshape(B * G, T, H, W)
    w_g = weight.reshape(T, Cg, G, Og).transpose(2, 0, 1, 3)
    ref = deform_sample_accum(
        jnp.asarray(xg), jnp.asarray(flows.astype(np.float32)), jnp.asarray(m),
        jnp.asarray(w_g), interpret=True,
    )
    ref = np.asarray(ref).reshape(B, G, H, W, Og).transpose(0, 2, 3, 1, 4).reshape(B, H, W, G * Og)
    out = deform_plain(*_t(x, off, masks), _oihw(weight), None, G, K)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_deform_gradient_matches_tpuvc():
    """The kernel's backward is autograd of the plain version; on the CPU
    that is what runs, and it matches JAX's gradient of tpuvc's formulation."""
    G, Cg, Og = 2, 3, 2
    x, off, masks, weight, bias = _inputs(1, 8, 10, G, Cg, Og, "fractional", seed=3)
    g = np.random.default_rng(4).standard_normal((1, 8, 10, G * Og)).astype(np.float32)

    def loss(*a):
        return jnp.sum(_deform_taps(*a, G, K, fused=False, force_xla=True) * g)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, off, masks, weight, bias))
    )
    ts = [t.requires_grad_() for t in (*_t(x, off, masks), _oihw(weight), torch.from_numpy(bias))]
    (deform_conv2d(*ts, G, K) * torch.from_numpy(g)).sum().backward()
    grads = [t.grad.numpy() for t in ts]
    grads[3] = grads[3].transpose(2, 3, 1, 0)  # OIHW -> HWIO
    for name, a, b in zip(("x", "offsets", "masks", "weight", "bias"), grads, ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("magnitude", [10.0, 40.0])
def test_offset_diversity_matches_tpuvc(magnitude):
    """OffsetDiversity: heads split into tanh-bounded (dy, dx) offsets around
    the flow and sigmoid masks, both references in one 16-group deform conv.
    tpuvc's DeformConv keeps an HWIO kernel named ``weight``; the converter
    turns it into the port's OIHW weight."""
    F, H, W = 16, 10, 12
    rng = np.random.default_rng(11)
    x1, x2 = (rng.standard_normal((2, H, W, F)).astype(np.float32) for _ in range(2))
    h1, h2 = (rng.standard_normal((2, H, W, 216)).astype(np.float32) for _ in range(2))
    f1, f2 = ((3.0 * rng.standard_normal((2, H, W, 2))).astype(np.float32) for _ in range(2))
    args = (x1, h1, f1, x2, h2, f2)
    jmod = JOffsetDiversity(features=F, magnitude=magnitude)
    v = jmod.init(jax.random.key(0), *map(jnp.asarray, args))
    v = jax.tree.map(lambda a: np.asarray(a) + 0.1, v)  # a nonzero bias too
    tmod = OffsetDiversity(F, magnitude)
    tmod.load_state_dict(params_from_jax(v))
    ref = np.asarray(jmod.apply(v, *map(jnp.asarray, args)))
    with torch.no_grad():
        out = tmod(*_t(*args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
