"""Still-image (Kodak) RD evaluation of the ELIC intra codec (port of
tpuvc.cli.test_image).

    python -m tpuvc_torch.cli.test_image dataset.name=kodak \
        dataset.root=/data/kodak 'levels=(0,1,2,3,4)' output_dir=out
    python -m tpuvc_torch.cli.test_image --device cpu dataset.name=synthetic \
        dataset.height=64 dataset.width=96 'levels=(0,)' output_dir=/tmp/out

Parity: the reference's I-frame models are evaluated on Kodak through
KodakTestDataset + compressai_image_compress (LHBDC/test/utils.py:206-247);
ICIP2023/2024 load one ELIC intra checkpoint per rate level
(ICIP2023/src/test.py:149-155). Per-level weights are read from
``{intra_weights}/level_{k}/latest.msgpack`` when present, else
``{intra_weights}/latest.msgpack`` (tpuvc's flax checkpoints, converted by
``params_from_jax``), else seeded weights (structural runs).
``dataset.name=synthetic`` needs no data on disk: three random images of
``dataset.height`` x ``dataset.width``. Bits are ELIC's likelihood bits
(the ``dequantize`` forward), no streams. Runs on ``--device`` (default
``cuda``; no quiet fallback to the CPU).
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    """Run the eval; returns {"results": the results CSV rows, "info": the
    TestInfographic, "levels": {level: {"psnr", "bpp", "seconds"}} (each
    level's wall time, weights loaded before it), "images": images a
    level}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from tpuvc_torch import resolve_device
    from tpuvc_torch.config import TestConfig, apply_overrides, load_yaml

    cfg = load_yaml(args.config) if args.config else TestConfig()
    apply_overrides(cfg, args.overrides)
    device = resolve_device(args.device)

    import torch

    from tpuvc_torch.cli.test import make_intra_fn
    from tpuvc_torch.data.kodak import ImageFolder, SyntheticImages
    from tpuvc_torch.eval.image_runner import eval_images
    from tpuvc_torch.eval.infographic import TestInfographic
    from tpuvc_torch.models.elic import ELIC
    from tpuvc_torch.ops.precision import policy_from_name, set_deterministic
    from tpuvc_torch.utils.checkpoint import load_checkpoint
    from tpuvc_torch.utils.convert import params_from_jax

    set_deterministic(device)
    os.makedirs(cfg.output_dir, exist_ok=True)
    if cfg.dataset.name == "synthetic":
        dataset = SyntheticImages(
            n=3, h=cfg.dataset.height, w=cfg.dataset.width, seed=cfg.seed
        )
    else:
        dataset = ImageFolder(cfg.dataset.root)

    intra = ELIC(generator=torch.Generator().manual_seed(cfg.seed))
    seeded = {k: v.clone() for k, v in intra.state_dict().items()}
    intra = intra.to(device).eval()
    forward = make_intra_fn(intra)

    def intra_fn(x):
        return forward(torch.from_numpy(x).to(device))

    info = TestInfographic(
        extra_columns=("msssim",) if cfg.eval_msssim else ()
    )
    levels, loaded = {}, None  # the checkpoint in the model; None: seeded
    t0 = time.perf_counter()
    with policy_from_name(cfg.compute_dtype), torch.inference_mode():
        for level in cfg.levels:
            ck = next((c for c in (
                os.path.join(cfg.intra_weights, f"level_{level}", "latest.msgpack"),
                os.path.join(cfg.intra_weights, "latest.msgpack"),
            ) if os.path.exists(c)), None)
            if ck != loaded:
                state = params_from_jax(load_checkpoint(ck)) if ck else seeded
                intra.load_state_dict(state, strict=True)
                loaded = ck
            if ck:
                print(f"level {level}: loaded {ck}")

            t_level = time.perf_counter()
            psnrs, bpps = eval_images(
                dataset,
                intra_fn,
                name=cfg.dataset.name,
                level=level,
                info=info,
                compute_msssim=cfg.eval_msssim,
            )
            mean_p = sum(psnrs) / len(psnrs)
            mean_b = sum(bpps) / len(bpps)
            levels[level] = {"psnr": mean_p, "bpp": mean_b,
                             "seconds": time.perf_counter() - t_level}
            print(f"level {level}: psnr {mean_p:.2f} bpp {mean_b:.4f}")
    seconds = time.perf_counter() - t0

    out = info.results_csv(os.path.join(cfg.output_dir, cfg.results_csv))
    print("level sequence psnr bpp")
    for r in out:
        print(f"{r['level']} {r['sequence']} {r['psnr']:.4f} {r['bpp']:.6f}")
    print(f"elapsed {seconds:.1f}s")
    return {"results": out, "info": info, "levels": levels, "images": len(dataset)}


if __name__ == "__main__":
    main()
