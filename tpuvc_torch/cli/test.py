"""Full-sequence RD evaluation entry point (port of tpuvc.cli.test).

    python -m tpuvc_torch.cli.test --config cfg.yaml model.family=flowguided_b \
        dataset.root=/data/UVG results_csv=results.csv
    python -m tpuvc_torch.cli.test --device cpu dataset.name=synthetic \
        'dataset.sequences={"synth": 9}' dataset.gop=4 dataset.width=64 \
        dataset.height=64 model.family=lhbdc 'levels=(0,)' output_dir=/tmp/out

Walks levels x sequences in the GOP's coding order, codes I-frames with the
ELIC intra codec and B-frames with the chosen family (likelihood forwards:
bits from the likelihoods, no streams), and writes the ICIP-format results
CSV (level, sequence, psnr, bpp). FlowGuidedB picks each B-frame's motion
down ratio by the flow-only prediction search
(``adaptive_down_ratio=True``, tpuvc's default); ``level_batched=True``
codes each hierarchy level in batched forwards at down ratio 1. DeformB
codes at rate level s = level; Flex-Rate takes each B-frame's (n, l) from
its RD point's table by the frame's hierarchy level
(``gop.rate_control.flexrate_rate_for_frame``).

Weights: ``{intra_weights}/latest.msgpack`` and
``{inter_weights}/latest.msgpack`` (tpuvc's flax checkpoints, converted by
``params_from_jax``) when present, seeded weights otherwise. Runs on
``--device`` (default ``cuda``; no quiet fallback to the CPU). Family
``dmc``, ``write_plots`` and ``device_count > 1`` are not ported yet and
exit naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import collections
import math
import os
import time

#: What tpuvc's test CLI does that the port does not yet, and where
#: ROADMAP.md queues it.
NOT_PORTED_FAMILIES = {
    "dmc": "ROADMAP.md queue A, A14 (DMC P-frame)",
}


def check_unported(cfg) -> None:
    fam = cfg.model.family
    if fam in NOT_PORTED_FAMILIES:
        raise SystemExit(f"family {fam!r} is not ported to tpuvc_torch yet: "
                         f"{NOT_PORTED_FAMILIES[fam]}")
    if cfg.write_plots:
        raise SystemExit("write_plots is not ported to tpuvc_torch yet: "
                         "ROADMAP.md queue A, A16 (eval/plots.py)")
    if cfg.device_count > 1:
        raise SystemExit("device_count > 1 is not ported to tpuvc_torch yet: "
                         "ROADMAP.md queue A, A16 (parallel/mesh.py)")


def build_models(cfg, rng_seed: int = 0):
    """(ELIC at full width, the family's B model), weights drawn from one
    ``torch.Generator`` seeded with ``rng_seed``."""
    import torch

    from tpuvc_torch.models.elic import ELIC

    mc = cfg.model
    g = torch.Generator().manual_seed(rng_seed)
    intra = ELIC(generator=g)
    if mc.family == "lhbdc":
        from tpuvc_torch.models.lhbdc import LHBDC

        model = LHBDC(N=mc.N, generator=g)
    elif mc.family == "flexrate":
        from tpuvc_torch.models.flexrate import BidirFlowRef

        model = BidirFlowRef(N=mc.N, generator=g)
    elif mc.family == "deform_b":
        from tpuvc_torch.models.deform_b import DeformB

        model = DeformB(N=mc.N, M=mc.M, levels=mc.levels, generator=g)
    elif mc.family == "flowguided_b":
        from tpuvc_torch.models.flowguided_b import FlowGuidedB

        model = FlowGuidedB(
            N=mc.N, M=mc.M, levels=mc.levels,
            feature_channels=tuple(mc.feature_channels), generator=g,
        )
    else:
        raise ValueError(f"unknown model family: {mc.family}")
    return intra, model


def make_frame_fns(cfg, intra_pack, inter_pack, level: int, ratios=None):
    """(intra_fn, inter_fn) closures for eval_sequence. ``ratios``, a
    Counter, counts the down ratio each FlowGuidedB frame was coded at."""
    import torch

    from tpuvc_torch.gop.adaptive import best_down_ratio_prediction
    from tpuvc_torch.models.flowguided_b import get_scales

    intra, model = intra_pack, inter_pack
    fam = cfg.model.family

    def intra_fn(x):
        out = intra(x, "dequantize")
        bits = sum(
            -torch.sum(torch.log2(torch.clamp(p, min=1e-9)))
            for p in out["likelihoods"].values()
        )
        return out["x_hat"], bits

    if fam == "lhbdc":

        def inter_fn(r1, r2, xc, order, o1, o2):
            out = model(r1, xc, r2, "dequantize")
            return out["x_hat"], out["bits"]

    elif fam == "flexrate":
        from tpuvc_torch.gop.rate_control import flexrate_rate_for_frame

        def inter_fn(r1, r2, xc, order, o1, o2):
            d = max(abs(o2 - o1), 1)
            hier = max(1, int(round(math.log2(16 / d))) + 1)
            n, l = flexrate_rate_for_frame(level, hier)
            out = model(r1, xc, r2, n, l, "dequantize")
            return out["x_hat"], torch.sum(out["size"])

    elif fam == "deform_b":

        def inter_fn(r1, r2, xc, order, o1, o2):
            out = model(r1, r2, xc, float(level), "dequantize")
            return out["x_hat"], out["size"]

    elif fam == "flowguided_b":

        def inter_fn(r1, r2, xc, order, o1, o2):
            s1, s2 = get_scales(order, o1, o2)
            if cfg.adaptive_down_ratio:
                ratio, _ = best_down_ratio_prediction(
                    lambda r: model.prediction_flowonly(r1, r2, s1, s2, r), xc
                )
            else:
                ratio = 1
            if ratios is not None:
                ratios[ratio] += 1
            out = model(r1, r2, xc, float(level), s1, s2, ratio, "dequantize")
            return out["x_hat"], out["size"]

    else:
        raise ValueError(fam)
    return intra_fn, inter_fn


def make_batched_inter_fn(cfg, inter_pack, level: int, gop: int):
    """Level-batched inter forward for eval_sequence_batched.

    Frames within one hierarchy level share their temporal geometry (the
    same v4 scales, the same Flex-Rate (n, l)), so one batched call serves
    the whole level. The v4 per-frame down-ratio search is off on this path
    (down_ratio 1); the sequential runner is the adaptive one."""
    from tpuvc_torch.models.flowguided_b import get_scales

    model = inter_pack
    fam = cfg.model.family
    if fam == "lhbdc":

        def inter_fn(r1, r2, xc, idxs, refs):
            out = model(r1, xc, r2, "dequantize")
            return out["x_hat"], out["sizes"]

    elif fam == "flexrate":
        from tpuvc_torch.gop.rate_control import flexrate_rate_for_frame

        def inter_fn(r1, r2, xc, idxs, refs):
            d = max(abs(refs[0][1] - refs[0][0]), 1)
            hier = max(1, int(round(math.log2(gop / d))) + 1)
            n, l = flexrate_rate_for_frame(level, hier)
            out = model(r1, xc, r2, n, l, "dequantize")
            return out["x_hat"], out["size"]

    elif fam == "deform_b":

        def inter_fn(r1, r2, xc, idxs, refs):
            out = model(r1, r2, xc, float(level), "dequantize")
            return out["x_hat"], out["sizes"]

    elif fam == "flowguided_b":

        def inter_fn(r1, r2, xc, idxs, refs):
            s1, s2 = get_scales(idxs[0], refs[0][0], refs[0][1])
            out = model(r1, r2, xc, float(level), s1, s2, 1, "dequantize")
            return out["x_hat"], out["sizes"]

    else:
        raise ValueError(f"level_batched unsupported for family: {fam}")
    return inter_fn


def load_weights(module, directory: str, what: str) -> None:
    """Load ``{directory}/latest.msgpack`` into ``module`` when it exists."""
    from tpuvc_torch.utils.checkpoint import load_checkpoint
    from tpuvc_torch.utils.convert import params_from_jax

    path = os.path.join(directory, "latest.msgpack")
    if os.path.exists(path):
        module.load_state_dict(params_from_jax(load_checkpoint(path)), strict=True)
        print(f"loaded {what} weights from {path}")


def main(argv=None):
    """Run the eval; returns {"results": the results CSV rows, "info": the
    TestInfographic, "down_ratios": {ratio: frames}, "frames": frames
    coded, "seconds": the eval's wall time (models built before it)}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from tpuvc_torch import resolve_device
    from tpuvc_torch.config import TestConfig, apply_overrides, load_yaml
    from tpuvc_torch.eval.infographic import TestInfographic
    from tpuvc_torch.ops.precision import policy_from_name, set_deterministic

    cfg = load_yaml(args.config) if args.config else TestConfig()
    apply_overrides(cfg, args.overrides)
    check_unported(cfg)
    device = resolve_device(args.device)
    set_deterministic()

    if cfg.timestamped_output:
        # hydra run-dir layout: outputs/%Y-%m-%d/%H-%M-%S
        cfg.output_dir = os.path.join(
            cfg.output_dir, time.strftime("%Y-%m-%d"), time.strftime("%H-%M-%S")
        )
        print(f"run dir: {cfg.output_dir}")
    os.makedirs(cfg.output_dir, exist_ok=True)
    intra, model = build_models(cfg, cfg.seed)
    load_weights(intra, cfg.intra_weights, "intra")
    load_weights(model, cfg.inter_weights, "inter")
    intra, model = intra.to(device).eval(), model.to(device).eval()

    info = TestInfographic(extra_columns=("msssim",) if cfg.eval_msssim else ())
    t0 = time.perf_counter()
    with policy_from_name(cfg.compute_dtype):
        ratios = _run_levels(cfg, intra, model, info, device)
    seconds = time.perf_counter() - t0
    out = info.results_csv(os.path.join(cfg.output_dir, cfg.results_csv))
    print("level sequence psnr bpp")
    for r in out:
        print(f"{r['level']} {r['sequence']} {r['psnr']:.4f} {r['bpp']:.6f}")
    if ratios:
        print(f"down ratios chosen: {dict(sorted(ratios.items()))}")
    print(f"elapsed {seconds:.1f}s")
    return {"results": out, "info": info, "down_ratios": dict(ratios),
            "frames": len(info.rows), "seconds": seconds}


def _run_levels(cfg, intra_pack, inter_pack, info, device):
    """Evaluate every level x sequence of ``cfg`` into ``info``; returns a
    Counter of the down ratios FlowGuidedB's search chose."""
    import torch

    from tpuvc_torch.data.uvg import SequenceFrames, SyntheticSequence, device_frame
    from tpuvc_torch.eval.runner import eval_sequence, eval_sequence_batched
    from tpuvc_torch.gop.order import get_order_typ_list, sequence_order_from_table

    ratios = collections.Counter()
    for level in cfg.levels:
        intra_fn, inter_fn = make_frame_fns(cfg, intra_pack, inter_pack, level, ratios)
        for seq, n_frames in cfg.dataset.sequences.items():
            if cfg.dataset.name == "synthetic":
                frames = SyntheticSequence(
                    n_frames=n_frames, h=cfg.dataset.height, w=cfg.dataset.width,
                )
            else:
                frames = SequenceFrames(os.path.join(cfg.dataset.root, seq), n_frames)
            if cfg.dataset.gop == 16:
                order, typ = get_order_typ_list(16, len(frames))
            else:
                # LHBDC-era protocol: static dyadic tables tiled per GOP.
                order, typ = sequence_order_from_table(cfg.dataset.gop, len(frames))

            class _Device:
                """Lazy host-to-device frame access (uint8 uploads): a long
                sequence never sits on the device at once."""

                def __getitem__(self, i):
                    return device_frame(frames.u8(i), device)

            with torch.inference_mode():
                if cfg.level_batched:
                    gop = cfg.dataset.gop
                    n_use = ((len(frames) - 1) // gop) * gop + 1
                    if n_use != len(frames):
                        print(f"level_batched: covering {n_use}/{len(frames)} "
                              f"frames of {seq} (largest k*{gop}+1 prefix)")
                    inter_b = make_batched_inter_fn(cfg, inter_pack, level, gop)
                    psnrs, sizes = eval_sequence_batched(
                        _Device(), len(frames), gop, intra_fn, inter_b,
                        crop_hw=frames.size, video=seq, level=level, info=info,
                        max_batch=cfg.max_batch, compute_msssim=cfg.eval_msssim,
                        window_gops=cfg.window_gops,
                    )
                else:
                    psnrs, sizes = eval_sequence(
                        _Device(), order, typ, intra_fn, inter_fn,
                        crop_hw=frames.size, video=seq, level=level, info=info,
                        compute_msssim=cfg.eval_msssim,
                    )
            print(
                f"level {level} {seq}: psnr {sum(psnrs) / len(psnrs):.2f} bpp "
                f"{sum(sizes) / len(sizes) / (frames.size[0] * frames.size[1]):.4f}"
            )
    return ratios


if __name__ == "__main__":
    main()
