"""End-to-end RD-optimized training entry point (port of tpuvc.cli.train).

    python -m tpuvc_torch.cli.train model.family=lhbdc dataset_root=/data/vimeo \\
        total_steps=1000000
    python -m tpuvc_torch.cli.train model.family=flowguided_b  # two-stage recursive
    python -m tpuvc_torch.cli.train model.family=elic          # intra codec
    python -m tpuvc_torch.cli.train model.family=dmc           # cascaded P-frame
    python -m tpuvc_torch.cli.train --device cpu model.family=lhbdc model.N=16 \\
        batch_size=2 crop=64 total_steps=2 workers=0 prefetch=0 checkpoint_dir=ck

Families: ``lhbdc`` (single B, noise quantization), ``elic`` (intra, noise,
``i_stage2``), ``flowguided_b`` (two-stage recursive, straight-through
rounding, a random level and down ratio per step), ``deform_b`` and
``flexrate`` (two-stage recursive, noise), ``dmc`` (cascaded P-frames,
straight-through, a random rate level per step). Every step runs the
forward on ``--device`` (default ``cuda``: the warp and deform kernels; no
quiet fallback to the CPU) and the backward through autograd, under
PyTorch's deterministic algorithms (``ops.precision.deterministic_training``):
two runs from one seed give the same bits, the kernels' backward included
(its gather adds in a fixed order, not with float atomics). Without the
dataset at ``dataset_root`` the run trains on synthetic septuplets, as
tpuvc's does.

Batches are uploaded as uint8 and converted on the device. The rate level,
down ratio (FlowGuidedB) and DMC rate level of each step are drawn from
``np.random.default_rng(seed)`` in tpuvc's order; the batch stream equals
tpuvc's for a seed. The quantization noise of step ``it`` is seeded from
``(seed + 1, it)`` (tpuvc_torch.train.trainer.noise_seeds): it cannot equal
JAX's draws from ``fold_in(key(seed + 1), it)``.

Checkpoints are tpuvc's flax-msgpack trees (``latest.msgpack`` every
``val_every`` steps and at the end, ``best.msgpack`` when the validation
BD-rate improves), so a run resumes from, and its weights load in, either
package.

Data-parallel training runs one process per device, launched by torchrun
(``python -m torch.distributed.run --nproc_per_node N -m
tpuvc_torch.cli.train ...``), as tpuvc's runs over every visible device:
every rank draws the same seeded global batch and trains on its rows of it
(tpuvc_torch.train.trainer.data_parallel averages the gradients before each
update, from rank 0's broadcast parameters and optimizer state), so the
ranks' parameters stay bit-identical; a run checks that at its end. Rank 0
alone logs, writes checkpoints and the summary. ``batch_size`` must divide
by N. ``--dist_backend`` names the transport (default nccl on cuda, gloo on
the CPU; ranks that share a card need gloo). The last log line,
``summary {...}``, gives the run's rates, last metrics, the steps the
optimizer dropped for non-finite gradients, peak device memory and kernel
launches; ``main`` returns the same dict.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time

#: Frames a batch window holds, by family. Flex-Rate trains through the
#: 5-frame recursive step, so it takes 5-frame windows; tpuvc gives it 3,
#: and JAX's clamped indexing then codes the last frame from a reference
#: equal to it (ROADMAP.md, section C).
WINDOW = {"lhbdc": 3, "elic": 3, "flowguided_b": 5, "deform_b": 5, "flexrate": 5}

#: DMC's rate levels (its _HyperCoder gain levels).
DMC_LEVELS = 4


def make_bd_validator(cfg, fam, model, log, device):
    """Validation half of the BD-rate checkpointing: code a small
    validation clip set at every rate level and return the (bpps, psnrs)
    curve; the caller feeds it to ``BDCheckpointer`` against the fixed
    anchor ``ANCHORS["icip2024_train"]``.

    Returns validate() -> (bpps, psnrs), or None for single-rate families.
    """
    if fam not in ("flexrate", "deform_b", "flowguided_b"):
        return None

    import numpy as np
    import torch

    from tpuvc_torch.data.uvg import SequenceFrames, SyntheticSequence
    from tpuvc_torch.eval.metrics import psnr_uint8_np

    val_root = getattr(cfg, "val_root", "")
    if val_root and os.path.isdir(val_root):
        seqs = [
            SequenceFrames(os.path.join(val_root, d), n_frames=3)
            for d in sorted(os.listdir(val_root))[:2]
        ]
    else:
        seqs = [SyntheticSequence(n_frames=3, seed=s) for s in range(2)]
    clips = [tuple(torch.from_numpy(seq[i]).to(device) for i in range(3)) for seq in seqs]
    levels = list(range(cfg.model.levels))

    if fam == "flowguided_b":
        def run(r1, xc, r2, s):
            return model(r1, r2, xc, float(s), 0.5, -0.5, 1, "dequantize")
    elif fam == "deform_b":
        def run(r1, xc, r2, s):
            return model(r1, r2, xc, float(s), "dequantize")
    else:  # flexrate: integer gain level n, interpolation l = 1
        def run(r1, xc, r2, s):
            return model(r1, xc, r2, s, 1.0, "dequantize")

    def to_u8(x):
        return (np.clip(x[0].cpu().numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)

    @torch.no_grad()
    def validate():
        """-> (bpps, psnrs) level curve for the BDCheckpointer."""
        bpps, psnrs = [], []
        for s in levels:
            ps, rs = [], []
            for r1, xc, r2 in clips:
                out = run(r1, xc, r2, s)
                ps.append(psnr_uint8_np(to_u8(xc), to_u8(out["x_hat"])))
                rs.append(float(torch.mean(out["rate"])))
            psnrs.append(float(np.mean(ps)))
            bpps.append(float(np.mean(rs)))
        log.info("val levels bpp=%s psnr=%s",
                 [round(b, 4) for b in bpps], [round(p, 2) for p in psnrs])
        return bpps, psnrs

    return validate


def code_fn_for(fam: str, model, mode: str | None = None):
    """The recursive families' code_fn(ref1, ref2, xcur, seed, order,
    order1, order2, level, down_ratio) -> (x_hat, rate), in tpuvc's mode
    for the family (FlowGuidedB 'ste', DeformB and Flex-Rate 'noise')
    unless ``mode`` says otherwise."""
    import torch

    from tpuvc_torch.train.trainer import generator

    if fam == "flowguided_b":
        from tpuvc_torch.models.flowguided_b import get_scales

        mode = mode or "ste"

        def code_fn(r1, r2, xc, seed, order, o1, o2, level, dr):
            s1, s2 = get_scales(order, o1, o2)
            out = model(r1, r2, xc, level, s1, s2, dr, mode,
                        generator=generator(seed, xc.device))
            return out["x_hat"], out["rate"]
    elif fam == "deform_b":
        mode = mode or "noise"

        def code_fn(r1, r2, xc, seed, order, o1, o2, level, dr):
            out = model(r1, r2, xc, level, mode, generator=generator(seed, xc.device))
            return out["x_hat"], out["rate"]
    elif fam == "flexrate":
        mode = mode or "noise"

        def code_fn(r1, r2, xc, seed, order, o1, o2, level, dr):
            out = model(r1, xc, r2, level, 1.0, mode, generator=generator(seed, xc.device))
            return out["x_hat"], torch.mean(out["rate"])
    else:
        raise ValueError(f"not a recursive family: {fam}")
    return code_fn


def make_elic_step(model, tx, lam: float, stage2: bool, mode: str = "noise"):
    """ELIC's intra step: lam * 255^2 * MSE + bpp + aux on the first frame
    of each window, ``stage2`` as tpuvc's ``i_stage2``. Returns
    step(params, opt_state, batch, key); ``step.loss_fn(batch, key)``."""
    import torch

    from tpuvc_torch.train.trainer import finish_step, generator, noise_seeds

    def loss_fn(batch, key):
        x = batch[:, 0]
        out = model(x, mode, generator=generator(noise_seeds(key, 1)[0], x.device),
                    stage2=stage2)
        floor = torch.full((), 1e-9, dtype=x.dtype, device=x.device)
        # jnp.maximum's gradient: half at the floor the likelihoods already sit on
        bits = sum(-torch.sum(torch.log2(torch.maximum(p, floor)))
                   for p in out["likelihoods"].values())
        n_pix = x.shape[0] * x.shape[1] * x.shape[2]
        mse = torch.mean((out["x_hat"] - x) ** 2)
        aux = model.aux_loss()
        return lam * 255**2 * mse + bits / n_pix + aux, {
            "mse": mse, "rate": bits / n_pix, "aux": aux}

    def step(params, opt_state, batch, key):
        loss, metrics = loss_fn(batch, key)
        return finish_step(loss, metrics, params, opt_state, tx)

    step.loss_fn = loss_fn
    return step


def build_family(cfg, tx, np_rng):
    """(model on the CPU with weights seeded from ``cfg.seed``, run_step,
    frames a window holds). run_step(params, opt, batch, key, it) ->
    (params, opt, metrics, frames coded)."""
    import torch

    fam = cfg.model.family
    gen = torch.Generator().manual_seed(cfg.seed)
    if fam == "lhbdc":
        from tpuvc_torch.models.lhbdc import LHBDC
        from tpuvc_torch.train.trainer import make_lhbdc_step

        model = LHBDC(N=cfg.model.N, generator=gen)
        step_fn = make_lhbdc_step(model, tx, alpha=cfg.alpha, distortion=cfg.distortion)

        def run_step(params, opt, batch, key, it):
            return (*step_fn(params, opt, batch, key), batch.shape[0])

    elif fam == "elic":
        from tpuvc_torch.models.elic import ELIC

        model = (ELIC(N=cfg.model.N, M=cfg.model.M, generator=gen) if cfg.model.M != 128
                 else ELIC(generator=gen))
        step_fn = make_elic_step(model, tx, cfg.i_lambda, cfg.i_stage2)

        def run_step(params, opt, batch, key, it):
            return (*step_fn(params, opt, batch, key), batch.shape[0])

    elif fam in ("flowguided_b", "deform_b", "flexrate"):
        from tpuvc_torch.train.trainer import make_recursive_step

        if fam == "flowguided_b":
            from tpuvc_torch.models.flowguided_b import FlowGuidedB

            model = FlowGuidedB(N=cfg.model.N, M=cfg.model.M, levels=cfg.model.levels,
                                feature_channels=tuple(cfg.model.feature_channels),
                                generator=gen)
        elif fam == "deform_b":
            from tpuvc_torch.models.deform_b import DeformB

            model = DeformB(N=cfg.model.N, M=cfg.model.M, levels=cfg.model.levels,
                            generator=gen)
        else:
            from tpuvc_torch.models.flexrate import BidirFlowRef

            model = BidirFlowRef(N=cfg.model.N, generator=gen)
        rec_step = make_recursive_step(code_fn_for(fam, model), model.aux_loss, tx,
                                       beta=cfg.beta, remat=True, distortion=cfg.distortion)

        def run_step(params, opt, batch, key, it):
            stage2 = it >= cfg.stage2_start
            level = int(np_rng.integers(0, cfg.model.levels))
            dr = int(np_rng.choice([1, 2, 4])) if fam == "flowguided_b" else 1
            out = rec_step(params, opt, batch, key, stage2, level, dr)
            return (*out, batch.shape[0] * (3 if stage2 else 1))

    elif fam == "dmc":
        from tpuvc_torch.models.dmc import PFrameDMC
        from tpuvc_torch.train.trainer import make_dmc_step

        # Canonical DMC size (N=64 latents, 48 feature channels), whatever
        # model.N says for the B-frame families.
        model = PFrameDMC(generator=gen)
        dmc_step = make_dmc_step(model, tx, beta=cfg.beta, n_pframes=cfg.n_pframes,
                                 distortion=cfg.distortion, warp_weight=cfg.warp_weight)

        def run_step(params, opt, batch, key, it):
            q = float(np_rng.integers(0, DMC_LEVELS))
            return (*dmc_step(params, opt, batch, key, q), batch.shape[0] * cfg.n_pframes)

    else:
        raise ValueError(f"unknown family: {fam}")
    n_frames = cfg.n_pframes + 1 if fam == "dmc" else WINDOW[fam]
    return model, run_step, n_frames


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    p.add_argument("--dist_backend", default=None,
                   help="torch.distributed backend under torchrun (default nccl "
                        "on cuda, gloo on the CPU)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from tpuvc_torch.config import TrainConfig, apply_overrides, load_yaml
    from tpuvc_torch.parallel.mesh import make_mesh, world_size

    cfg = load_yaml(args.config, TrainConfig) if args.config else TrainConfig()
    apply_overrides(cfg, args.overrides)
    mesh = None
    if world_size() > 1:
        if cfg.batch_size % world_size():
            raise SystemExit(f"batch_size={cfg.batch_size} does not divide over "
                             f"WORLD_SIZE={world_size()} ranks")
        mesh = make_mesh(backend=args.dist_backend, device=args.device)
    rank0 = mesh is None or mesh.rank == 0

    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    log = logging.getLogger("tpuvc_torch.train")
    # Rank 0 alone logs (and writes train.log); the others say only warnings.
    log.setLevel(logging.INFO if rank0 else logging.WARNING)
    log.propagate = False
    fmt = logging.Formatter("%(asctime)s %(message)s")
    handlers = [logging.StreamHandler()]
    if rank0:
        handlers.append(logging.FileHandler(os.path.join(cfg.checkpoint_dir, "train.log")))
    for h in handlers:
        h.setFormatter(fmt)
        log.addHandler(h)
    try:
        return _train(cfg, args.device, log, mesh)
    finally:
        for h in handlers:
            log.removeHandler(h)
            h.close()
        if mesh is not None:
            mesh.close()


def params_sha256(params: dict) -> str:
    """One digest of every tensor's bytes, in the parameters' order."""
    import hashlib

    h = hashlib.sha256()
    for n, p in params.items():
        h.update(n.encode())
        h.update(hashlib.sha256(p.detach().cpu().contiguous().numpy().tobytes()).digest())
    return h.hexdigest()


def _train(cfg, device_name: str, log, mesh=None) -> dict:
    """Train under deterministic_training: two runs from one seed and one
    batch stream give the same bits."""
    from tpuvc_torch import resolve_device
    from tpuvc_torch.ops.precision import deterministic_training

    device = resolve_device(device_name) if mesh is None else mesh.device
    with deterministic_training(device):
        return _train_on(cfg, device, log, mesh)


def _train_on(cfg, device, log, mesh=None) -> dict:
    import numpy as np
    import torch

    from tpuvc_torch.data.vimeo import SyntheticSeptuplets, VimeoSeptuplets, make_batch_iterator
    from tpuvc_torch.ops import deform, warp
    from tpuvc_torch.ops.precision import policy_from_name
    from tpuvc_torch.parallel.mesh import all_gather_objects, replicate, shard_batch
    from tpuvc_torch.train.trainer import data_parallel, make_optimizer
    from tpuvc_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from tpuvc_torch.utils.convert import params_from_jax, params_to_jax

    rank0 = mesh is None or mesh.rank == 0
    log.info("config: %s", cfg)
    log.info("seed: %d", cfg.seed)
    if mesh is not None:
        log.info("data-parallel over %d ranks (%s)", mesh.size, mesh.backend)
    np_rng = np.random.default_rng(cfg.seed)

    if os.path.isdir(cfg.dataset_root):
        dataset = VimeoSeptuplets(cfg.dataset_root)
    else:
        log.warning("dataset root %s missing; using synthetic data", cfg.dataset_root)
        dataset = SyntheticSeptuplets(n=256, size=cfg.crop + 32)

    fam = cfg.model.family
    tx = make_optimizer(
        lr=cfg.lr, aux_lr=cfg.aux_lr, grad_clip=cfg.grad_clip,
        lr_drop_step=cfg.lr_drop_step, skip_nonfinite=cfg.skip_nonfinite,
        plateau_patience=cfg.plateau_patience or None,
    )
    model, run_step, n_frames = build_family(cfg, tx, np_rng)
    batches = make_batch_iterator(
        dataset, cfg.batch_size, cfg.crop, n_frames=n_frames, seed=cfg.seed,
        workers=cfg.workers, prefetch=cfg.prefetch, raw_uint8=True,
    )

    start_step = 0
    resume = os.path.join(cfg.checkpoint_dir, "latest.msgpack")
    if os.path.exists(resume):
        ck = load_checkpoint(resume)
        model.load_state_dict(params_from_jax(ck["params"]))
        start_step = int(ck.get("step", 0))
        log.info("resumed from %s at step %d", resume, start_step)
    model.to(device)
    params = dict(model.named_parameters())
    opt_state = tx.init(params)
    if mesh is not None:
        params = replicate(mesh, params)
        opt_state = replicate(mesh, opt_state)

    validator = make_bd_validator(cfg, fam, model, log, device)
    bd_ck = None
    if validator is not None:
        from tpuvc_torch.eval.bd_rate import ANCHORS
        from tpuvc_torch.train.trainer import BDCheckpointer

        anchor_bpp, anchor_psnr = ANCHORS["icip2024_train"]
        def save_best(state):
            # Every rank validates (the same curve), so the checkpointer's
            # state agrees across ranks; rank 0 writes.
            if rank0:
                save_checkpoint(os.path.join(cfg.checkpoint_dir, "best.msgpack"), state)

        bd_ck = BDCheckpointer(anchor_bpp, anchor_psnr, save_fn=save_best)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = (warp.warp_kernel.launches, deform.deform_kernel.launches)
    step_s, coded_frames, metrics, validations = [], [], {}, 0
    t0 = time.perf_counter()
    for it in range(start_step, cfg.total_steps):
        t_step = time.perf_counter()
        # uint8 upload and on-device conversion: a quarter of the float
        # batch's host-to-device traffic, the same values as to_float
        # (every rank draws the global batch and uploads its rows of it)
        batch = torch.from_numpy(next(batches))
        ranks = contextlib.nullcontext()
        if mesh is not None:
            ranks = data_parallel(mesh, batch.shape[0])
            batch = shard_batch(mesh, batch)
        batch = batch.to(device).to(torch.float32) / 255.0
        with policy_from_name(cfg.compute_dtype), ranks:
            params, opt_state, metrics, coded = run_step(
                params, opt_state, batch, (cfg.seed + 1, it), it)
        sync()
        step_s.append(time.perf_counter() - t_step)
        coded_frames.append(coded * (1 if mesh is None else mesh.size))
        if it % 100 == 0 or it + 1 == cfg.total_steps:
            m = {k: float(v) for k, v in metrics.items()}
            rate = (it + 1 - start_step) / (time.perf_counter() - t0)
            log.info("step %d %s (%.2f it/s)", it, m, rate)
        if (it + 1) % cfg.val_every == 0 or it + 1 == cfg.total_steps:
            if rank0:
                save_checkpoint(resume, {"params": params_to_jax(model), "step": it + 1})
                log.info("checkpointed at step %d", it + 1)
            if validator is not None:
                validations += 1
                bpps, psnrs = validator()
                if bd_ck.update(bpps, psnrs, {"params": params_to_jax(model), "step": it + 1}):
                    log.info("BD-rate improved to %.2f%% — saved best.msgpack", bd_ck.best_bd)

    later = sum(step_s[1:])
    summary = {
        "family": fam, "device": str(device), "steps": len(step_s), "start_step": start_step,
        "batch": cfg.batch_size, "crop": cfg.crop, "frames_coded": sum(coded_frames),
        "first_step_s": step_s[0] if step_s else None,
        "steps_per_s_after_first": (len(step_s) - 1) / later if later else None,
        "frames_per_s_after_first": sum(coded_frames[1:]) / later if later else None,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "skipped_nonfinite": opt_state.total_notfinite,
        "launches": {"warp": warp.warp_kernel.launches - launches0[0],
                     "deform": deform.deform_kernel.launches - launches0[1]},
        "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None),
        "validations": validations,
        "best_bd_rate": bd_ck.best_bd if bd_ck is not None else None,
        "params_sha256": params_sha256(params),
    }
    if mesh is not None:
        # The ranks applied the same updates: their parameters must agree.
        digests = all_gather_objects(mesh, summary["params_sha256"])
        summary.update(world_size=mesh.size, dist_backend=mesh.backend,
                       rank_params_sha256=digests)
        if len(set(digests)) != 1:
            raise RuntimeError(f"the ranks' parameters differ after training: {digests}")
    log.info("summary %s", json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
