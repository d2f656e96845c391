"""Helpers for the tests that hold tpuvc_torch's training against tpuvc's.

tpuvc's steps return updated parameters, not gradients. ``GRAB`` is an
optax transform that returns zero updates and keeps the gradients as its
state, so ``step(params, GRAB.init(params), ...)`` runs tpuvc's own loss
and ``jax.value_and_grad`` and hands the gradients back exactly.
``ste`` swaps tpuvc's hard-coded 'noise' mode for 'ste' (deterministic,
so both packages compute the same loss).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tpuvc_torch.utils.convert import params_to_jax

GRAB = optax.GradientTransformationExtraArgs(
    init=lambda params: jax.tree.map(jnp.zeros_like, params),
    update=lambda grads, state, params=None, **extra: (
        jax.tree.map(jnp.zeros_like, grads), grads),
)

#: The gradient bar: each tensor within this fraction of its max |g|.
GRAD_BAR = 2e-3


class _Ste:
    def __init__(self, model):
        self.model = model

    def apply(self, variables, *args, rng=None, **kw):
        args = tuple("ste" if isinstance(a, str) and a == "noise" else a for a in args)
        if kw.get("mode") == "noise":
            kw["mode"] = "ste"
        return self.model.apply(variables, *args, **kw)


def ste(model):
    """``model`` as tpuvc's steps call it, but 'ste' where they ask for
    'noise' (the PRNG key dropped); ``type(...).aux_loss`` is the model's."""
    cls = type(f"Ste{type(model).__name__}", (_Ste,), {"aux_loss": type(model).aux_loss})
    return cls(model)


def grads_tree(model: torch.nn.Module, grads: dict) -> dict:
    """Port gradients by state-dict name -> tpuvc's tree layout."""
    shadow = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in shadow.named_parameters():
            p.copy_(grads[n])
    return params_to_jax(shadow)


def port_grads(loss, model: torch.nn.Module) -> dict:
    params = dict(model.named_parameters())
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), got)}


def compare_grads(port_tree: dict, jax_tree, bar: float = GRAD_BAR) -> dict:
    """Every leaf of ``jax_tree`` (tpuvc's gradients) against the port's:
    |port - tpuvc| <= bar * max|tpuvc| per tensor. Returns the worst
    relative error by path (for the failure message)."""
    ref = dict(jax.tree_util.tree_flatten_with_path(jax_tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(port_tree)[0])
    assert ref.keys() == got.keys(), set(map(str, ref)) ^ set(map(str, got))
    worst, bad = {}, {}
    for path, r in ref.items():
        r = np.asarray(r, np.float64)
        g = np.asarray(got[path], np.float64)
        scale = np.abs(r).max()
        err = np.abs(g - r).max()
        key = jax.tree_util.keystr(path)
        worst[key] = err / scale if scale > 0 else err
        if err > bar * scale and not (scale == 0 and err < 1e-12):
            bad[key] = (err, scale)
    assert not bad, f"{len(bad)} of {len(ref)} gradients off: {dict(list(bad.items())[:8])}"
    return worst


def batch_np(shape, seed=0):
    """A float32 window (B, T, H, W, 3) of one drifting texture."""
    rng = np.random.default_rng(seed)
    B, T, H, W, C = shape
    base = rng.random((B, 1, H, W, C), dtype=np.float32)
    drift = 0.05 * rng.standard_normal((B, 1, H, W, C)).astype(np.float32)
    t = np.arange(T, dtype=np.float32).reshape(1, T, 1, 1, 1)
    return np.clip(base + (t - T // 2) * drift, 0, 1).astype(np.float32)


def float64_parity(jfn, params, tmodel, tfn, batch):
    """Both packages in float64 (``jax.enable_x64``; the port's module and
    inputs in double): the losses within 1e-5 relative and every gradient
    tensor at the bar. ``jfn(params, batch)`` -> (loss, grads) through
    tpuvc's step; ``tfn(batch)`` -> the port's loss. Returns the worst
    relative gradient error by path."""
    with jax.enable_x64(True):
        p = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        jloss, jgrads = jfn(p, jnp.asarray(batch.astype(np.float64)))
        jloss, jgrads = float(jloss), jax.tree.map(np.asarray, jgrads)
    tmodel.to(torch.float64)
    tloss = tfn(torch.from_numpy(batch.astype(np.float64)))
    loss = float(tloss.detach())
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    return compare_grads(grads_tree(tmodel, port_grads(tloss, tmodel)), jgrads)


def recursive_parity(fam, jmodel, params, tmodel, batch, stage2, level, dr, beta=0.0207):
    """One family's recursive-step loss and gradients through tpuvc's and
    the port's ``make_recursive_step`` in 'ste', held by float64_parity;
    tpuvc's code_fn as its cli/train.py writes it, in 'ste'."""
    from tpuvc.train.trainer import make_recursive_step as jstep
    from tpuvc_torch.cli.train import code_fn_for
    from tpuvc_torch.train.trainer import make_optimizer, make_recursive_step

    if fam == "flowguided_b":
        from tpuvc.models.flowguided_b import get_scales

        def jcode(v, r1, r2, xc, key, order, o1, o2, lv, d):
            s1, s2 = get_scales(order, o1, o2)
            out = jmodel.apply({"params": v}, r1, r2, xc, lv, s1, s2, d, "ste")
            return out["x_hat"], out["rate"]
    elif fam == "deform_b":
        def jcode(v, r1, r2, xc, key, order, o1, o2, lv, d):
            out = jmodel.apply({"params": v}, r1, r2, xc, lv, "ste")
            return out["x_hat"], out["rate"]
    else:
        def jcode(v, r1, r2, xc, key, order, o1, o2, lv, d):
            out = jmodel.apply({"params": v}, r1, xc, r2, lv, 1.0, "ste")
            return out["x_hat"], jnp.mean(out["rate"])

    def jaux(v):
        return jmodel.apply({"params": v}, method=type(jmodel).aux_loss)

    jrec = jstep(jcode, jaux, GRAB, beta=beta, remat=False)

    def jfn(p, b):
        _, grads, met = jrec(p, GRAB.init(p), b, jax.random.key(0), stage2, level, dr)
        return met["loss"], grads

    trec = make_recursive_step(code_fn_for(fam, tmodel, mode="ste"), tmodel.aux_loss,
                               make_optimizer(), beta=beta, remat=True)
    return float64_parity(jfn, params, tmodel,
                          lambda b: trec.loss_fn(b, 0, stage2, level, dr)[0], batch)
