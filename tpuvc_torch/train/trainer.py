"""Trainers: single-B (LHBDC), two-stage recursive (ICIP2024) and cascaded
P-frame (DMC); port of tpuvc.train.trainer.

- LHBDC: alpha * MSE + rate, a separate Adam for the factorized priors'
  quantiles (lr 1e-3 against 1e-4), gradients clipped to a global norm of 1.
- Recursive (ICIP2024): a random rate level and down ratio per step; stage 1
  codes the middle frame of a 5-frame window from intra-coded endpoints,
  stage 2 also codes the quarter frames from (endpoint, middle
  reconstruction) and averages the three losses; lr 1e-4 -> 1e-5 at 500k.
- Optimizer split: the aux loss reaches only the quantiles and the main loss
  gives them no gradient, so one combined loss with a two-group optimizer is
  the reference's two-optimizer scheme.

A step takes the model's parameters as a dict name -> tensor
(``dict(model.named_parameters())``), updates them in place and returns
them. tpuvc's ``jax.checkpoint`` (``remat=True``) is
``torch.utils.checkpoint(use_reentrant=False)`` here.

Noise: a step takes a ``key`` (an int or a tuple of ints) where tpuvc takes
a JAX PRNG key. :func:`noise_seeds` splits it into one seed per coded frame,
drawn before the frame's forward, and the forward seeds a fresh
``torch.Generator`` on the batch's device from it. A checkpointed forward
that runs again in the backward therefore draws the same noise (checkpoint's
``preserve_rng_state`` restores only the default generators). The draws
cannot equal JAX's.

Data parallelism (tpuvc's sharded jit, where XLA inserts the gradient
all-reduce): each rank of a mesh runs the step on its rows of the global
batch inside :func:`data_parallel`, which gives its frames their rows of
the global batch's noise and makes :func:`finish_step` average the
gradients, the loss and the metrics over the ranks (one flattened
all-reduce in the parameters' order) before the update; every rank then
applies the same update to the same parameters.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

# Adam's constants (optax.adam's defaults).
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# reduce_on_plateau's (optax 0.2.6's defaults, which tpuvc keeps).
_PLATEAU_RTOL, _PLATEAU_ATOL, _PLATEAU_COOLDOWN, _PLATEAU_ACCUMULATION = 1e-4, 0.0, 0, 1


def is_aux(name: str) -> bool:
    """The 'aux' group: every parameter named ``quantiles``."""
    return "quantiles" in name.split(".")


@dataclass
class AdamState:
    count: int
    mu: dict
    nu: dict


@dataclass
class PlateauState:
    """optax.contrib.reduce_on_plateau's state, float32 on the host."""

    scale: np.float32 = np.float32(1.0)
    best_value: np.float32 = np.float32(np.inf)
    plateau_count: int = 0
    cooldown_count: int = 0
    count: int = 0
    avg_value: np.float32 = np.float32(0.0)


@dataclass
class OptState:
    main: AdamState
    aux: AdamState
    plateau: PlateauState | None = None
    notfinite_count: int = 0
    total_notfinite: int = 0


class Optimizer:
    """tpuvc's optax transform (:func:`make_optimizer`) on named tensors.

    ``update(grads, state, params, value)`` -> (updates, state), as optax's
    ``tx.update``; :func:`apply_updates` adds the updates to the
    parameters. The step counters, the plateau logic and the finiteness
    test live on the host (one device sync a step); the moments on the
    parameters' device. Every operation follows optax's in float32.
    """

    def __init__(self, lr, aux_lr, grad_clip, lr_drop_step, drop_factor,
                 skip_nonfinite, plateau_patience, plateau_factor, plateau_min_scale):
        self.lr, self.aux_lr = lr, aux_lr
        self.grad_clip = grad_clip
        self.lr_drop_step, self.drop_factor = lr_drop_step, drop_factor
        self.skip_nonfinite = skip_nonfinite
        self.plateau_patience = plateau_patience
        self.plateau_factor = np.float32(plateau_factor)
        self.plateau_min_scale = np.float32(plateau_min_scale)

    def init(self, params: dict) -> OptState:
        def adam(names):
            zeros = {n: torch.zeros_like(params[n]) for n in names}
            return AdamState(0, zeros, {n: z.clone() for n, z in zeros.items()})

        aux = [n for n in params if is_aux(n)]
        main = [n for n in params if not is_aux(n)]
        plateau = PlateauState() if self.plateau_patience is not None else None
        return OptState(main=adam(main), aux=adam(aux), plateau=plateau)

    def schedule(self, base: float, count: int) -> np.float32:
        """optax.piecewise_constant_schedule(base, {lr_drop_step:
        drop_factor}) at update count ``count`` (0-based)."""
        v = np.float32(base)
        if self.lr_drop_step is not None and count >= self.lr_drop_step:
            v = np.float32(self.drop_factor) * v
        return v

    @staticmethod
    def _adam(grads: dict, st: AdamState, lr: np.float32):
        count = st.count + 1
        bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(count))
        mu, nu, out = {}, {}, {}
        for n, g in grads.items():
            mu[n] = (1 - _B1) * g + _B1 * st.mu[n]
            nu[n] = (1 - _B2) * (g * g) + _B2 * st.nu[n]
            u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + _EPS)
            out[n] = float(-lr) * u
        return out, AdamState(count, mu, nu)

    def _plateau(self, st: PlateauState, value) -> PlateauState:
        """reduce_on_plateau's update of its state (optax 0.2.6)."""
        count = st.count + 1
        avg = np.float32((np.float32(st.count) * st.avg_value + np.float32(value))
                         / np.float32(count))
        st = replace(st, count=count, avg_value=avg)
        if count != _PLATEAU_ACCUMULATION:
            return st
        improved = avg < np.float32(1 - _PLATEAU_RTOL) * st.best_value - np.float32(
            _PLATEAU_ATOL)
        best = avg if improved else st.best_value
        plateau_count = 0 if improved else st.plateau_count + 1
        if st.cooldown_count > 0:
            plateau_count, scale, cooldown = 0, st.scale, st.cooldown_count - 1
        else:
            hit = plateau_count == self.plateau_patience
            scale = max(st.scale * self.plateau_factor if hit else st.scale,
                        self.plateau_min_scale)
            plateau_count = 0 if hit else plateau_count
            cooldown = _PLATEAU_COOLDOWN if hit else 0
        return PlateauState(scale=np.float32(scale), best_value=np.float32(best),
                            plateau_count=plateau_count, cooldown_count=cooldown,
                            count=0, avg_value=np.float32(0.0))

    def update(self, grads: dict, state: OptState, params: dict | None = None,
               value=None):
        """optax's ``tx.update(grads, state, params, value=value)``: one
        update per parameter, and the new state. Parameters without a
        gradient count as zero gradients."""
        if self.skip_nonfinite > 0:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
            notfinite = 0 if finite else state.notfinite_count + 1
            state = replace(state, notfinite_count=notfinite,
                            total_notfinite=state.total_notfinite + (not finite))
            if not finite and notfinite <= self.skip_nonfinite:
                # apply_if_finite: zero updates, the inner state kept
                return {n: torch.zeros_like(g) for n, g in grads.items()}, state

        main = {n: grads[n] for n in state.main.mu}
        aux = {n: grads[n] for n in state.aux.mu}
        # clip_by_global_norm over the main group
        norm = torch.sqrt(sum(torch.sum(g * g) for g in main.values()))
        keep = norm < self.grad_clip
        main = {n: torch.where(keep, g, (g / norm) * self.grad_clip) for n, g in main.items()}
        upd_main, main_state = self._adam(main, state.main,
                                          self.schedule(self.lr, state.main.count))
        plateau = state.plateau
        if plateau is not None:
            if value is None:
                raise ValueError("the plateau schedule needs the loss (value=...)")
            plateau = self._plateau(plateau, float(value))
            scale = float(plateau.scale)
            upd_main = {n: scale * u for n, u in upd_main.items()}
        upd_aux, aux_state = self._adam(aux, state.aux,
                                        self.schedule(self.aux_lr, state.aux.count))
        return {**upd_main, **upd_aux}, replace(state, main=main_state, aux=aux_state,
                                                plateau=plateau)


def apply_updates(params: dict, updates: dict) -> dict:
    """optax.apply_updates, in place: p <- p + u."""
    with torch.no_grad():
        for n, p in params.items():
            p.add_(updates[n].to(p.dtype))
    return params


def make_optimizer(
    lr: float = 1e-4,
    aux_lr: float = 1e-3,
    grad_clip: float = 1.0,
    lr_drop_step: int | None = 500_000,
    drop_factor: float = 0.1,
    skip_nonfinite: int = 0,
    plateau_patience: int | None = None,
    plateau_factor: float = 0.5,
    plateau_min_scale: float = 0.01,
) -> Optimizer:
    """Two groups: 'aux' (the quantiles) takes Adam alone at ``aux_lr``;
    'main' (the rest) takes clip-by-global-norm, then Adam at ``lr``, then,
    with ``plateau_patience``, ReduceLROnPlateau (mode 'min', the update
    scaled by ``plateau_factor`` after that many non-improving steps,
    floored at ``plateau_min_scale``). Both learning rates drop by
    ``drop_factor`` from update ``lr_drop_step`` (0-based) on.

    ``skip_nonfinite > 0``: a step whose gradients hold NaN or inf changes
    neither parameters nor state (optax.apply_if_finite); after that many
    consecutive bad steps updates pass again, so a divergence shows."""
    return Optimizer(lr, aux_lr, grad_clip, lr_drop_step, drop_factor,
                     skip_nonfinite, plateau_patience, plateau_factor,
                     plateau_min_scale)


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def init_state(params, tx) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def noise_seeds(key, n: int) -> list[int]:
    """``n`` generator seeds from ``key`` (an int or a tuple of ints): the
    port's jax.random.split, through numpy's SeedSequence, so one key gives
    the same seeds on every device and in every process."""
    return [int(s) for s in np.random.SeedSequence(key).generate_state(n)]


#: (mesh, global batch) of the data-parallel steps running now, or None.
#: A module global, not a contextvar: a checkpointed forward runs again in
#: the backward, on autograd's device thread.
_DATA_PARALLEL = None


@contextlib.contextmanager
def data_parallel(mesh, batch: int):
    """Run the steps inside as this rank's share of data-parallel steps
    over ``mesh`` (tpuvc_torch.parallel.mesh) on a global batch of
    ``batch`` rows, this rank holding ``shard_batch``'s rows of it."""
    global _DATA_PARALLEL
    if batch % mesh.size:
        raise ValueError(f"batch {batch} does not divide over a mesh of {mesh.size}")
    prev, _DATA_PARALLEL = _DATA_PARALLEL, (mesh, batch)
    try:
        yield
    finally:
        _DATA_PARALLEL = prev


def generator(seed: int, device):
    """A fresh generator on ``device`` seeded with ``seed``; inside
    :func:`data_parallel`, a :class:`~tpuvc_torch.entropy.quant.RowNoise`
    that gives this rank its rows of the global batch's draws."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if _DATA_PARALLEL is None:
        return gen
    from tpuvc_torch.entropy.quant import RowNoise

    mesh, batch = _DATA_PARALLEL
    return RowNoise(gen, batch, mesh.rank * (batch // mesh.size))


def _grads(loss, params: dict) -> dict:
    names = list(params)
    got = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, got)}


def mean_over_ranks(mesh, grads: dict, loss, metrics: dict):
    """(grads, loss, metrics) averaged over the ranks of ``mesh``: the
    gradients flattened in their dict's order into one all-reduce, the
    loss and the tensor metrics in another."""
    from tpuvc_torch.parallel.mesh import all_reduce_mean

    names = list(grads)
    flat = all_reduce_mean(mesh, torch.cat([grads[n].reshape(-1) for n in names]))
    out, at = {}, 0
    for n in names:
        size = grads[n].numel()
        out[n] = flat[at : at + size].view_as(grads[n])
        at += size
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    vals = all_reduce_mean(mesh, torch.stack(
        [loss.detach().float()] + [metrics[k].detach().float().reshape(()) for k in keys]))
    metrics = {**metrics, **{k: vals[i + 1] for i, k in enumerate(keys)}}
    return out, vals[0], metrics


def finish_step(loss, metrics: dict, params: dict, opt_state, tx):
    """The rest of a step after its loss: gradients (averaged over the
    ranks inside :func:`data_parallel`), ``tx.update`` with the loss as the
    plateau's value, the update applied in place, and the metrics (the loss
    among them) detached."""
    grads = _grads(loss, params)
    if _DATA_PARALLEL is not None:
        grads, loss, metrics = mean_over_ranks(_DATA_PARALLEL[0], grads, loss, metrics)
    updates, opt_state = tx.update(grads, opt_state, params, value=loss.detach())
    apply_updates(params, updates)
    metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    return params, opt_state, metrics


def make_lhbdc_step(model, tx, alpha: float, distortion: str = "mse",
                    mode: str = "noise"):
    """Single-B training step for LHBDC-style codecs.

    batch: (B, 3, H, W, C) triplets [before, current, after]. distortion:
    'mse' or 'ms_ssim' (needs crops >= 176 px). ``mode`` is tpuvc's
    'noise'; the tests pass 'ste' to compare gradients with tpuvc's.
    Returns step(params, opt_state, batch, key) -> (params, opt_state,
    metrics); ``step.loss_fn(batch, key)`` -> (loss, metrics).
    """
    from tpuvc_torch.train.loss import distortion_fn

    dist, _ = distortion_fn(distortion)

    def loss_fn(batch, key):
        xb, xc, xa = batch[:, 0], batch[:, 1], batch[:, 2]
        gen = generator(noise_seeds(key, 1)[0], batch.device)
        out = model(xb, xc, xa, mode, generator=gen)
        d = dist(out["x_hat"], xc)
        rate = torch.mean(out["rate"])
        aux = model.aux_loss()
        return alpha * d + rate + aux, {"mse": d, "rate": rate, "aux": aux}

    def step(params, opt_state, batch, key):
        loss, metrics = loss_fn(batch, key)
        return finish_step(loss, metrics, params, opt_state, tx)

    step.loss_fn = loss_fn
    return step


def make_recursive_step(
    code_fn: Callable,
    aux_fn: Callable,
    tx,
    beta: float,
    intra_fn: Callable | None = None,
    remat: bool = True,
    distortion: str = "mse",
):
    """Two-stage recursive training step (ICIP2024 style).

    Args:
      code_fn(ref1, ref2, xcur, seed, order, order1, order2, level,
              down_ratio) -> (x_hat, rate); ``seed`` seeds the call's noise
              generator (:func:`generator`).
      aux_fn() -> aux loss.
      intra_fn(x) -> intra reconstruction (frozen; identity if None).
      batch: (B, 5, H, W, C) windows [f1..f5].

    Returns step(params, opt_state, batch, key, stage2, level, down_ratio);
    ``step.loss_fn(batch, key, stage2, level, down_ratio)`` -> (loss,
    metrics). Besides tpuvc's metrics (loss, aux) it reports the mean rate
    and distortion of the coded frames.
    """
    if intra_fn is None:
        intra_fn = lambda x: x  # noqa: E731
    if remat:
        def coded(*args):
            return checkpoint(code_fn, *args, use_reentrant=False)
    else:
        coded = code_fn
    from tpuvc_torch.train.loss import distortion_fn

    dist, dist_scale = distortion_fn(distortion)

    def loss_fn(batch, key, stage2, level, down_ratio):
        if batch.shape[1] != 5:
            raise ValueError(f"the recursive step takes 5-frame windows, got {batch.shape[1]}")
        f = [batch[:, i] for i in range(5)]
        with torch.no_grad():
            dec1 = intra_fn(f[0])
            dec5 = intra_fn(f[4])
        seeds = noise_seeds(key, 3)
        frames = [(coded(dec1, dec5, f[2], seeds[0], 2, 0, 4, level, down_ratio), f[2])]
        if stage2:
            x3 = frames[0][0][0]
            frames.append((coded(dec1, x3, f[1], seeds[1], 1, 0, 2, level, down_ratio), f[1]))
            frames.append((coded(x3, dec5, f[3], seeds[2], 3, 2, 4, level, down_ratio), f[3]))
        ds = [dist(x_hat, x) for (x_hat, _), x in frames]
        rates = [torch.mean(rate) for (_, rate), _ in frames]
        loss = beta * dist_scale * ds[0] + rates[0]
        if stage2:
            loss = (loss + (beta * dist_scale * ds[1] + rates[1])
                    + (beta * dist_scale * ds[2] + rates[2])) / 3.0
        aux = aux_fn()
        n = len(frames)
        return loss + aux, {"aux": aux, "rate": sum(rates) / n, "mse": sum(ds) / n}

    def step(params, opt_state, batch, key, stage2, level, down_ratio):
        loss, metrics = loss_fn(batch, key, stage2, level, down_ratio)
        return finish_step(loss, metrics, params, opt_state, tx)

    step.loss_fn = loss_fn
    return step


def initial_dpb(model, frame):
    """The DPB of a chain's first P-frame, from the ground-truth frame 0:
    zero feature and latent priors (the DCVC "fresh after intra" state)."""
    from tpuvc_torch.models.dmc import MV_FEAT

    B, H, W, _ = frame.shape

    def zeros(*shape):
        return torch.zeros(shape, dtype=frame.dtype, device=frame.device)

    return {
        "ref_frame": frame,
        "ref_feature": zeros(B, H, W, model.feat),
        "ref_mv_feature": zeros(B, H, W, MV_FEAT),
        "ref_y": zeros(B, H // 8, W // 8, model.N),
        "ref_mv_y": zeros(B, H // 8, W // 8, model.N),
        "ref_down_ratio": 1.0,
    }


def make_dmc_step(
    model,
    tx,
    beta: float,
    n_pframes: int = 2,
    remat: bool = True,
    distortion: str = "mse",
    warp_weight: float = 0.0,
):
    """Cascaded P-frame training step for the DMC codec (low delay).

    Ground-truth frame 0 seeds the DPB; each following frame is coded
    against the propagated decoded frame and feature, in 'ste' mode, and the
    per-frame RD losses are averaged, so gradients flow through the
    propagation chain.

    Args:
      batch: (B, n_pframes+1, H, W, C) consecutive frames.
      warp_weight: optional motion-bootstrapping term
        warp_weight * MSE(warp(ref, mv_hat), x).

    Returns step(params, opt_state, batch, key, q) (q: the rate level,
    fractional allowed); ``step.loss_fn(batch, key, q)`` -> (loss,
    metrics).
    """
    from tpuvc_torch.train.loss import distortion_fn

    dist, dist_scale = distortion_fn(distortion)

    def code_one(x, dpb, seed, q):
        out = model(x, dpb, 1.0, "ste", generator=generator(seed, x.device), q=q)
        return out["x_hat"], out["dpb"], out["warped"], out["rate"]

    if remat:
        def coded(*args):
            return checkpoint(code_one, *args, use_reentrant=False)
    else:
        coded = code_one

    def loss_fn(batch, key, q):
        n = batch.shape[1]
        dpb = initial_dpb(model, batch[:, 0])
        seeds = noise_seeds(key, n - 1)
        loss = tot_rate = tot_dist = 0.0
        for i in range(1, n):
            x = batch[:, i]
            x_hat, dpb, warped, rate = coded(x, dpb, seeds[i - 1], q)
            d = dist(x_hat, x)
            loss = loss + beta * dist_scale * d + torch.mean(rate)
            if warp_weight:
                loss = loss + warp_weight * torch.mean((warped - x) ** 2)
            tot_rate = tot_rate + torch.mean(rate)
            tot_dist = tot_dist + d
        loss = loss / (n - 1)
        aux = model.aux_loss()
        return loss + aux, {"aux": aux, "rate": tot_rate / (n - 1),
                            "mse": tot_dist / (n - 1)}

    def step(params, opt_state, batch, key, q):
        loss, metrics = loss_fn(batch, key, q)
        return finish_step(loss, metrics, params, opt_state, tx)

    step.loss_fn = loss_fn
    return step


class BDCheckpointer:
    """Keep the checkpoint whose validation BD-rate against a fixed anchor
    is best (checkpoint on BD-rate improvement, not on loss)."""

    def __init__(self, anchor_rates, anchor_psnrs, save_fn: Callable):
        self.anchor = (list(anchor_rates), list(anchor_psnrs))
        self.best_bd = float("inf")
        self.save_fn = save_fn

    def update(self, rates, psnrs, state) -> bool:
        from tpuvc_torch.eval.bd_rate import bd_rate

        bd = bd_rate(self.anchor[0], self.anchor[1], rates, psnrs)
        if bd < self.best_bd:
            self.best_bd = bd
            self.save_fn(state)
            return True
        return False
