"""tpuvc_torch.train's losses and optimizer against tpuvc's on the CPU.

The optimizer is held against optax's transform from tpuvc's
``make_optimizer`` over 30 fixed numpy gradient steps: the main/aux split,
clip-by-global-norm, Adam, the piecewise-constant drop, reduce-on-plateau
and apply_if_finite, with a NaN step, an ``lr_drop_step`` crossing and a
plateau on the way. Parameters agree within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvc_torch.train import loss as tl
from tpuvc_torch.train.trainer import apply_updates, make_optimizer

torch.set_num_threads(1)

SHAPES = {"enc.Conv_0.kernel": (3, 4), "enc.entropy_bottleneck.quantiles": (2, 1, 3),
          "dec.bias": (5,), "dec.entropy_bottleneck.matrix_0": (2, 3, 1)}


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *parts, name = k.split(".")
        for p in parts:
            node = node.setdefault(p, {})
        node[name] = v
    return out


def _run(kw, nan_steps, losses, steps=30, seed=0):
    from tpuvc.train.trainer import make_optimizer as jmake

    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for i in range(steps):
        scale = 3.0 if i % 4 == 0 else 0.05  # the clip binds on some steps only
        g = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
        if i in nan_steps:
            g["dec.bias"][1] = np.nan
        grads.append(g)

    tx = jmake(**kw)
    jp = _nest({k: jnp.asarray(v) for k, v in p0.items()})
    js = tx.init(jp)
    tx_t = make_optimizer(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = tx_t.init(tp)
    for i, g in enumerate(grads):
        upd, js = tx.update(_nest({k: jnp.asarray(v) for k, v in g.items()}), js, jp,
                            value=jnp.float32(losses[i]))
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        tu, ts = tx_t.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                             value=torch.tensor(losses[i]))
        apply_updates(tp, tu)
        for k in SHAPES:
            ref = np.asarray(_nest_get(jp, k))
            got = tp[k].numpy()
            finite = np.abs(ref[np.isfinite(ref)])
            atol = 1e-6 * finite.max() if finite.size else 0.0
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=atol, err_msg=f"step {i} {k}")
    return tp, ts


def _nest_get(tree, key):
    for p in key.split("."):
        tree = tree[p]
    return tree


def test_optimizer_matches_optax_over_30_steps():
    # the loss falls for 10 steps, then sits: the plateau scale halves
    # after 3 non-improving steps, again after 3 more
    losses = [10.0 - i for i in range(10)] + [1.0] * 20
    tp, ts = _run(dict(lr=1e-2, aux_lr=1e-1, grad_clip=1.0, lr_drop_step=12,
                       skip_nonfinite=2, plateau_patience=3, plateau_min_scale=0.2),
                  nan_steps={7}, losses=losses)
    assert ts.total_notfinite == 1 and ts.main.count == 29 and ts.aux.count == 29
    assert float(ts.plateau.scale) == pytest.approx(0.2)  # floored at min_scale


def test_nonfinite_steps_pass_after_the_limit():
    """skip_nonfinite=2: the first two NaN steps in a row are dropped, the
    third goes through, so the divergence shows (NaN parameters)."""
    tp, ts = _run(dict(lr=1e-3, lr_drop_step=None, skip_nonfinite=2),
                  nan_steps={3, 4, 5}, losses=[1.0] * 8, steps=8)
    assert ts.notfinite_count == 0 and ts.total_notfinite == 3
    assert torch.isnan(tp["dec.bias"]).any() and ts.main.count == 6


@pytest.mark.parametrize("fn", ["rd_loss", "rd_loss_beta", "rd_loss_msssim"])
def test_rd_losses_match_tpuvc(fn):
    from tpuvc.train import loss as jl

    rng = np.random.default_rng(1)
    x = rng.random((1, 192, 192, 3), dtype=np.float32)
    x_hat = np.clip(x + 0.05 * rng.standard_normal(x.shape).astype(np.float32), 0, 1)
    rate = rng.random(3).astype(np.float32)
    w = {"rd_loss": tl.LHBDC_LAMBDAS[3], "rd_loss_beta": tl.ICIP_BETAS[2],
         "rd_loss_msssim": tl.MSSSIM_ALPHAS[2]}[fn]
    jloss, jd = getattr(jl, fn)(jnp.asarray(x_hat), jnp.asarray(x), jnp.asarray(rate), w)
    loss, d = getattr(tl, fn)(torch.from_numpy(x_hat), torch.from_numpy(x),
                              torch.from_numpy(rate), w)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # 1 - MS-SSIM: MS-SSIM itself agrees to float32 rounding of values near 1
    np.testing.assert_allclose(float(d), float(jd), rtol=1e-5, atol=2e-6)
    assert (tl.LHBDC_LAMBDAS, tl.ICIP_BETAS, tl.MSSSIM_ALPHAS) == (
        jl.LHBDC_LAMBDAS, jl.ICIP_BETAS, jl.MSSSIM_ALPHAS)


@pytest.mark.parametrize("name", ["mse", "ms_ssim"])
def test_distortion_fn_matches_tpuvc(name):
    from tpuvc.train.loss import distortion_fn as jdist

    rng = np.random.default_rng(2)
    x = rng.random((1, 176, 176, 3), dtype=np.float32)
    x_hat = np.clip(x + 0.1 * rng.standard_normal(x.shape).astype(np.float32), 0, 1)
    jf, js = jdist(name)
    tf, ts = tl.distortion_fn(name)
    assert ts == js
    np.testing.assert_allclose(float(tf(torch.from_numpy(x_hat), torch.from_numpy(x))),
                               float(jf(jnp.asarray(x_hat), jnp.asarray(x))), rtol=1e-5)


def test_msssim_gradient_finite_on_uncorrelated_input():
    """Early in training x_hat is nearly uncorrelated with x: the
    contrast-structure terms sit at their floor, and v**w must not give an
    infinite gradient there (tpuvc's tests/test_trainer.py holds the same)."""
    x = torch.from_numpy(np.random.default_rng(0).random((1, 192, 192, 3), dtype=np.float32))
    c = torch.tensor(1.0, requires_grad=True)
    loss, _ = tl.rd_loss_msssim(torch.full_like(x, 0.5) * c, x, 0.0, alpha=8.73)
    loss.backward()
    assert torch.isfinite(c.grad)
