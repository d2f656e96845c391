"""Three repairs that training needed, each held against tpuvc on the CPU:

- ``layers.leaky_relu`` has flax's gradient at exactly 0 (1, where
  ``F.leaky_relu`` gives the slope). A flax-initialised LHBDC has zero
  biases, z~ rounds to 0 and four leaky ReLUs of the hyper-synthesis sit at
  exactly 0: with ``F.leaky_relu`` its gradients came out 0.01**k of
  tpuvc's.
- ``emath.clip`` (the warp's border clamp, DMC's clamps) has ``jnp.clip``'s
  gradient at a bound (half; ``torch.clamp`` passes all of it): zero flow
  puts column 0's dx and row 0's dy exactly on the border.
- ``conv2d_nhwc`` hands oneDNN a contiguous NCHW input while autograd
  records a CPU conv: the backward of a 1x1 stride-2 conv on the
  channels-last view aborted the process.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_common import GRAB, float64_parity, ste
from tpuvc_torch.entropy.emath import clip
from tpuvc_torch.models.layers import leaky_relu
from tpuvc_torch.ops import warp as tw
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("slope", [0.01, 0.1])
def test_leaky_relu_gradient_at_zero_matches_flax(slope):
    x = np.array([-1.5, -0.0, 0.0, 2.0], np.float32)
    ref = jax.grad(lambda v: jnp.sum(jax.nn.leaky_relu(v, slope) * jnp.arange(1.0, 5.0)))(x)
    t = torch.tensor(x, requires_grad=True)
    (leaky_relu(t, slope) * torch.arange(1.0, 5.0)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(leaky_relu(t, slope).detach().numpy(),
                                  np.asarray(jax.nn.leaky_relu(x, slope)))


def test_clip_gradient_at_bounds_matches_jnp():
    x = np.array([-3.5, -3.0, 0.25, 3.0, 4.0], np.float32)
    w = np.arange(1.0, 6.0, dtype=np.float32)
    ref = jax.grad(lambda v: jnp.sum(jnp.clip(v, -3.0, 3.0) * w))(x)
    t = torch.tensor(x, requires_grad=True)
    (clip(t, -3.0, 3.0) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(ref))
    assert torch.equal(clip(t, -3.0, 3.0), torch.clamp(t, -3.0, 3.0))


@pytest.mark.parametrize("compat", ["exact", "lhbdc", "flexrate"])
def test_warp_gradients_at_zero_flow_match_tpuvc(compat):
    from tpuvc.ops.warp import warp as jwarp

    rng = np.random.default_rng(0)
    img = rng.random((1, 6, 7, 3), dtype=np.float32)
    flow = np.zeros((1, 6, 7, 2), np.float32)
    w = rng.standard_normal((1, 6, 7, 3)).astype(np.float32)

    def f(i, fl):
        return jnp.sum(jwarp(i, fl, compat=compat) * w)

    gi, gf = jax.grad(f, argnums=(0, 1))(img, flow)
    ti = torch.tensor(img, requires_grad=True)
    tf = torch.tensor(flow, requires_grad=True)
    (tw.warp(ti, tf, compat) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), rtol=0, atol=1e-6)


_CONV_BACKWARD = """
import sys, torch
from tpuvc_torch.models.layers import conv2d_nhwc
torch.set_num_threads(1)
for c in (3, 4, 8):
    x = torch.rand(2, 64, 64, c, requires_grad=True)
    w = torch.randn(16, c, 1, 1, requires_grad=True)
    b = torch.zeros(16, requires_grad=True)
    conv2d_nhwc(x, w, b, stride=2).sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()
print("ok")
"""


def test_strided_1x1_conv_backward_runs_on_the_cpu():
    """In a subprocess, so a crash fails this test instead of killing the
    worker."""
    proc = subprocess.run([sys.executable, "-c", _CONV_BACKWARD], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.returncode, proc.stderr[-2000:])


def test_lhbdc_flax_init_gradients_match_tpuvc():
    """LHBDC(N=16) with flax's own initialisation (zero biases), two 64x64
    triplets, 'ste': loss 1626 * MSE + rate + aux through each package's
    LHBDC step. The float32 losses agree within 1e-5; the gradients are held
    with both packages in float64 (torch_train_common.float64_parity): in
    float32 one sample point's bilinear cell flipping by rounding moves
    SPyNet's block gradients by 2.4e-3 to 3.7e-3 of their max on these
    inputs, in either package against its own float64 result."""
    from tpuvc.models.lhbdc import LHBDC as JLHBDC
    from tpuvc.train.trainer import make_lhbdc_step as jstep
    from tpuvc_torch.models.lhbdc import LHBDC
    from tpuvc_torch.train.trainer import make_lhbdc_step, make_optimizer

    rng = np.random.default_rng(1)
    base = rng.random((2, 1, 64, 64, 3), dtype=np.float32)
    drift = 0.05 * rng.standard_normal((2, 1, 64, 64, 3)).astype(np.float32)
    batch = np.clip(np.concatenate([base - drift, base, base + drift], axis=1), 0, 1)
    jm = JLHBDC(N=16)
    x0 = jnp.zeros((1, 64, 64, 3))
    params = jax.jit(jm.init, static_argnums=4)(jax.random.key(0), x0, x0, x0,
                                                "dequantize")["params"]
    params = jax.tree.map(np.asarray, params)
    jrun = jstep(ste(jm), GRAB, alpha=1626.0)

    def jfn(p, b):
        _, grads, met = jrun(p, GRAB.init(p), b, jax.random.key(1))
        return met["loss"], grads

    model = LHBDC(N=16)
    model.load_state_dict(params_from_jax(params))
    step = make_lhbdc_step(model, make_optimizer(), alpha=1626.0, mode="ste")
    with torch.no_grad():
        loss32 = float(step.loss_fn(torch.from_numpy(batch), 0)[0])
    jloss32 = float(jfn(jax.tree.map(jnp.asarray, params), jnp.asarray(batch))[0])
    assert abs(loss32 - jloss32) <= 1e-5 * abs(jloss32)
    worst = float64_parity(jfn, params, model, lambda b: step.loss_fn(b, 0)[0], batch)
    # the hyper-synthesis biases behind the four leaky ReLUs at exactly 0
    assert worst["['mv_compressor']['h_s_conv0']['bias']"] < 1e-4


def test_laplace_likelihood_gradient_finite_far_in_the_tail():
    """A latent ~20 scales from its mean: tpuvc's Laplace CDF overflows the
    branch its ``where`` does not select, so its gradient is NaN (DMC's
    training steps at batch 8 on 256x256 crops were all dropped as
    non-finite); the port's likelihood has tpuvc's values and a finite
    gradient, equal to tpuvc's wherever tpuvc's is finite."""
    from tpuvc.entropy.laplace import LaplaceConditional as JL
    from tpuvc_torch.entropy.laplace import LaplaceConditional

    y = np.array([0.0, 0.4, 2.0, 20.0, -25.0], np.float32)
    scales = np.array([1.0, 0.3, 0.5, 0.12, 0.11], np.float32)
    jl = JL()

    def f(v):
        return jnp.sum(jnp.log(jl.likelihood(v, scales)))

    jval = np.asarray(jl.likelihood(y, scales))
    jgrad = np.asarray(jax.grad(f)(y))
    t = torch.tensor(y, requires_grad=True)
    lik = LaplaceConditional().likelihood(t, torch.from_numpy(scales))
    torch.log(lik).sum().backward()
    np.testing.assert_array_equal(lik.detach().numpy(), jval)
    assert np.isnan(jgrad[3:]).all() and np.isfinite(t.grad.numpy()).all()
    np.testing.assert_allclose(t.grad.numpy()[:3], jgrad[:3], rtol=1e-6)


def test_training_after_inference_mode_in_one_process():
    """The port's cached device constants (SPyNet's normalisation, the
    resize matrices, the checkerboard masks) are made once per process; a
    forward under ``torch.inference_mode`` (the eval CLI's) that makes them
    first must not leave inference tensors that a later training step's
    autograd has to save."""
    from tpuvc_torch.models.flexrate import BidirFlowRef
    from tpuvc_torch.models.lhbdc import LHBDC
    from tpuvc_torch.models.spynet import _norm_consts
    from tpuvc_torch.ops.checkerboard import _anchor_mask_on
    from tpuvc_torch.ops.resample import _antialias_matrix_on, _resize_matrix_on

    for cached in (_norm_consts, _resize_matrix_on, _antialias_matrix_on, _anchor_mask_on):
        cached.cache_clear()
    g = torch.Generator().manual_seed(0)
    models = [LHBDC(N=16, generator=g), BidirFlowRef(n_levels=4, N=32, generator=g)]
    x = torch.rand((1, 64, 64, 3), generator=g)
    with torch.inference_mode():
        for m in models:
            m(x, x, x, *([] if isinstance(m, LHBDC) else [1, 1.0]), "dequantize")
    for m in models:
        out = m(x, x, x, *([] if isinstance(m, LHBDC) else [1, 1.0]), "ste")
        (out["x_hat"].mean() + out["rate"].mean()).backward()
        grads = [p.grad for p in m.parameters() if p.grad is not None]
        assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
