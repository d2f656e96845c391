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
(``gop.rate_control.flexrate_rate_for_frame``). Family ``dmc`` runs the
low-delay protocol instead: I-frames every ``dmc_intra_period``, chained
DMC P-frames at rate level q = level, each P-frame's down ratio chosen
from ``dmc_ratios`` by the fractional search with hysteresis
(``adaptive_down_ratio``), and a per-frame diagnostics CSV when
``dmc_diag_csv`` is set.

Weights: ``{intra_weights}/latest.msgpack`` and
``{inter_weights}/latest.msgpack`` (tpuvc's flax checkpoints, converted by
``params_from_jax``) when present, seeded weights otherwise. Runs on
``--device`` (default ``cuda``; no quiet fallback to the CPU).
``write_plots=true`` draws ``rd_curve.png`` and one
``{seq}_l{level}_frames.png`` per sequence and level beside the results
CSV; without matplotlib it exits naming it before the eval starts.
``device_count`` is read by nothing, as in tpuvc (whose config declares
it and whose eval runs on one device whatever it says).
"""

from __future__ import annotations

import argparse
import collections
import math
import os
import time

def check_unported(cfg) -> None:
    """Exit, before any work, on an option this machine cannot run:
    ``write_plots`` without matplotlib."""
    if cfg.write_plots:
        from tpuvc_torch.eval.plots import require_matplotlib

        try:
            require_matplotlib()
        except ImportError as e:
            raise SystemExit(f"write_plots=true: {e}") from e


def build_models(cfg, rng_seed: int = 0):
    """(ELIC at full width, the family's inter model), weights drawn from
    one ``torch.Generator`` seeded with ``rng_seed``."""
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
    elif mc.family == "dmc":
        from tpuvc_torch.models.dmc import PFrameDMC

        # DMC's canonical size (feat 48, N 64), whatever the B families'
        # model.N says, as tpuvc builds it.
        model = PFrameDMC(generator=g)
    else:
        raise ValueError(f"unknown model family: {mc.family}")
    return intra, model


def make_intra_fn(intra):
    """ELIC's likelihood forward: x -> (x_hat, bits)."""
    import torch

    def intra_fn(x):
        out = intra(x, "dequantize")
        bits = sum(
            -torch.sum(torch.log2(torch.clamp(p, min=1e-9)))
            for p in out["likelihoods"].values()
        )
        return out["x_hat"], bits

    return intra_fn


def make_frame_fns(cfg, intra_pack, inter_pack, level: int, ratios=None):
    """(intra_fn, inter_fn) closures for eval_sequence. ``ratios``, a
    Counter, counts the down ratio each FlowGuidedB frame was coded at."""
    import torch

    from tpuvc_torch.gop.adaptive import best_down_ratio_prediction
    from tpuvc_torch.models.flowguided_b import get_scales

    intra_fn, model = make_intra_fn(intra_pack), inter_pack
    fam = cfg.model.family

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


def make_dmc_fns(cfg, intra_pack, inter_pack, level: int, ratios=None):
    """(intra_fn, pframe_fn, ratio_for_frame) for the low-delay DMC eval: the
    likelihood forward at q = level, and the fractional down-ratio search
    over ``cfg.dmc_ratios`` with hysteresis toward the previous frame's
    ratio. ``ratios``, a Counter, counts the ratio each P-frame was coded
    at."""
    from tpuvc_torch.gop.adaptive import fractional_ratio_search, psnr_of

    model = inter_pack
    q = float(level)
    want_diag = bool(cfg.dmc_diag_csv)

    def pframe_fn(x, dpb, ratio):
        out = model(x, dpb, ratio, "dequantize", q=q)
        # Device scalars; the runner fetches them at the end of the sequence.
        extras = ({"warp_psnr": psnr_of(out["warped"], x), "bits_mv": out["bits_mv"],
                   "bits_y": out["bits_y"]} if want_diag else {})
        return out["x_hat"], out["bits"], out["dpb"], extras

    def ratio_for_frame(x, dpb):
        ratio = 1.0
        if cfg.adaptive_down_ratio:
            ratio, _, _ = fractional_ratio_search(
                lambda r: model.warp_prediction(x, dpb["ref_frame"], r), x,
                prev_ratio=dpb.get("ref_down_ratio"), ratios=tuple(cfg.dmc_ratios),
            )
        if ratios is not None:
            ratios[ratio] += 1
        return ratio

    return make_intra_fn(intra_pack), pframe_fn, ratio_for_frame


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
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="write the eval's spans and counters (tpuvc_torch.obs) "
                        "to PATH as JSON")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from tpuvc_torch import obs

    with obs.tracing(args.trace):
        return _evaluate(args)


def _evaluate(args) -> dict:
    """The eval CLI's body."""
    from tpuvc_torch import resolve_device
    from tpuvc_torch.config import TestConfig, apply_overrides, load_yaml
    from tpuvc_torch.eval.infographic import TestInfographic
    from tpuvc_torch.ops.precision import policy_from_name, set_deterministic

    cfg = load_yaml(args.config) if args.config else TestConfig()
    apply_overrides(cfg, args.overrides)
    check_unported(cfg)
    device = resolve_device(args.device)
    set_deterministic(device)

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
    if cfg.write_plots:
        write_plots(cfg, info)
    print(f"elapsed {seconds:.1f}s")
    return {"results": out, "info": info, "down_ratios": dict(ratios),
            "frames": len(info.rows), "seconds": seconds}


def write_plots(cfg, info) -> list[str]:
    """RD curve (levels aggregated over sequences, vs the BD anchors) and
    one per-frame PSNR/bpp twin-axis figure per (sequence, level), as
    tpuvc's ``_write_plots``; returns the paths written."""
    from tpuvc_torch.eval.plots import per_frame_figure, rd_curve

    lv = info.per_level()
    paths = [rd_curve(
        {cfg.model.family: ([r["bpp"] for r in lv], [r["psnr"] for r in lv])},
        os.path.join(cfg.output_dir, "rd_curve.png"),
        title=f"{cfg.model.family} RD",
    )]
    groups: dict = {}
    for r in info.rows:
        groups.setdefault((r["video"], r["level"]), []).append(r)
    for seq, level in sorted(groups):
        rows = sorted(groups[(seq, level)], key=lambda r: r["frame_num"])
        paths.append(per_frame_figure(
            [r["psnr"] for r in rows], [r["size"] for r in rows], rows[0]["pixels"],
            os.path.join(cfg.output_dir, f"{seq}_l{level}_frames.png"),
            title=f"{seq} level {level}",
        ))
    for path in paths:
        print(f"wrote {path}")
    return paths


def _run_levels(cfg, intra_pack, inter_pack, info, device):
    """Evaluate every level x sequence of ``cfg`` into ``info``; returns a
    Counter of the down ratios FlowGuidedB's (or DMC's) search chose."""
    import torch

    from tpuvc_torch.eval.runner import eval_sequence, eval_sequence_batched
    from tpuvc_torch.gop.order import get_order_typ_list, sequence_order_from_table

    ratios = collections.Counter()
    for level in cfg.levels:
        if cfg.model.family == "dmc":
            _run_dmc_level(cfg, intra_pack, inter_pack, level, info, device, ratios)
            continue
        intra_fn, inter_fn = make_frame_fns(cfg, intra_pack, inter_pack, level, ratios)
        for seq, n_frames in cfg.dataset.sequences.items():
            frames, dev_frames = _sequence(cfg, seq, n_frames, device)
            if cfg.dataset.gop == 16:
                order, typ = get_order_typ_list(16, len(frames))
            else:
                # LHBDC-era protocol: static dyadic tables tiled per GOP.
                order, typ = sequence_order_from_table(cfg.dataset.gop, len(frames))

            with torch.inference_mode():
                if cfg.level_batched:
                    gop = cfg.dataset.gop
                    n_use = ((len(frames) - 1) // gop) * gop + 1
                    if n_use != len(frames):
                        print(f"level_batched: covering {n_use}/{len(frames)} "
                              f"frames of {seq} (largest k*{gop}+1 prefix)")
                    inter_b = make_batched_inter_fn(cfg, inter_pack, level, gop)
                    psnrs, sizes = eval_sequence_batched(
                        dev_frames, len(frames), gop, intra_fn, inter_b,
                        crop_hw=frames.size, video=seq, level=level, info=info,
                        max_batch=cfg.max_batch, compute_msssim=cfg.eval_msssim,
                        window_gops=cfg.window_gops,
                    )
                else:
                    psnrs, sizes = eval_sequence(
                        dev_frames, order, typ, intra_fn, inter_fn,
                        crop_hw=frames.size, video=seq, level=level, info=info,
                        compute_msssim=cfg.eval_msssim,
                    )
            print(
                f"level {level} {seq}: psnr {sum(psnrs) / len(psnrs):.2f} bpp "
                f"{sum(sizes) / len(sizes) / (frames.size[0] * frames.size[1]):.4f}"
            )
    return ratios


def _sequence(cfg, seq: str, n_frames: int, device):
    """(the sequence's frame source, lazy device access to its frames):
    host-to-device uploads of uint8 frames, one at a time, so a long
    sequence never sits on the device at once."""
    from tpuvc_torch.data.uvg import SequenceFrames, SyntheticSequence, device_frame

    if cfg.dataset.name == "synthetic":
        frames = SyntheticSequence(n_frames=n_frames, h=cfg.dataset.height,
                                   w=cfg.dataset.width)
    else:
        frames = SequenceFrames(os.path.join(cfg.dataset.root, seq), n_frames)

    class _Device:
        def __getitem__(self, i):
            return device_frame(frames.u8(i), device)

    return frames, _Device()


def _run_dmc_level(cfg, intra_pack, inter_pack, level, info, device, ratios):
    """Low-delay DMC RD eval of one rate level: I every dmc_intra_period,
    chained P-frames, the fractional ratio search, and the per-frame
    diagnostics CSV ``{seq}_l{level}_{dmc_diag_csv}`` when asked for."""
    import torch

    from tpuvc_torch.eval.results_io import PerFrameDiagnostics
    from tpuvc_torch.eval.runner import eval_sequence_lowdelay

    intra_fn, pframe_fn, ratio_for_frame = make_dmc_fns(
        cfg, intra_pack, inter_pack, level, ratios
    )
    for seq, n_frames in cfg.dataset.sequences.items():
        frames, dev_frames = _sequence(cfg, seq, n_frames, device)
        diag = PerFrameDiagnostics() if cfg.dmc_diag_csv else None
        with torch.inference_mode():
            psnrs, sizes = eval_sequence_lowdelay(
                dev_frames, len(frames), cfg.dmc_intra_period, intra_fn, pframe_fn,
                crop_hw=frames.size, ratio_for_frame=ratio_for_frame, video=seq,
                level=level, info=info, diagnostics=diag, compute_msssim=cfg.eval_msssim,
            )
        if diag is not None:
            path = os.path.join(cfg.output_dir, f"{seq}_l{level}_{cfg.dmc_diag_csv}")
            print(f"wrote per-frame diagnostics to {diag.write(path)}")
        print(
            f"level {level} {seq}: psnr {sum(psnrs) / len(psnrs):.2f} bpp "
            f"{sum(sizes) / len(sizes) / (frames.size[0] * frames.size[1]):.4f}"
        )


if __name__ == "__main__":
    main()
