"""Where the device time of the port's main path goes, on one CUDA card.

Run from the repository root:

    python3 scripts/profile_torch_main_path.py [--family lhbdc|flowguided_b|deform_b|flexrate|dmc|elic|eval_lhbdc|eval_flowguided_b|image_eval|image_eval_bf16]

Codes chip_smoke.py's window (1088x1920, GOP-16, 2 GOPs, bfloat16 policy,
seeded weights) for one codec family: LHBDC(N=128) at batch 4 (the
default), FlowGuidedB or DeformB at full width at batch 2, or Flex-Rate
(N=128) at batch 4 (chip_smoke.py's v4, v3 and Flex-Rate paths); or, with
``dmc``, four chained DMC P-frames (feat 48, N 64, down ratio 1.0, q 0,
float32) from a DPB on source frame 0, encoded with encode_async and
decoded with decode_sequence (chip_smoke.py's main_path_dmc); or, with
``elic``, the window's three intra anchors (frames 0, 16,
32 of encode_v's synthetic sequence) through ELIC (N=192, M=320) at batch
3, as encode_v's --level_batched codes them; or, with ``eval_lhbdc`` /
``eval_flowguided_b``, the RD-eval CLI's level loop on chip_smoke.py's
eval_cli configurations (17 frames; LHBDC level-batched at batch cap 8 in
bfloat16, FlowGuidedB sequential with the down-ratio search and MS-SSIM in
float32), models built before the timed runs; or, with ``image_eval``
(``image_eval_bf16``), the still-image eval's level loop on chip_smoke.py's
image_eval_cli images (three synthetic 768x512 images, ELIC N=192 M=320
seeded, likelihood forward, float32 or bfloat16). An eval has no decode
side, so its "encode" is the eval and its "decode" is empty. It codes once to
warm up, then encodes and decodes again under torch.profiler, with the
determinism settings every CLI uses (TF32 off). Prints JSON lines: the
wall time of each side, the summed device time of all kernels and its
share of the wall time (the device's busy share; one stream, so kernels do
not overlap), the device time by kernel family, the 25 kernels with the
most device time, and the 10 convolution calls (by input, weight, stride
and padding shapes) whose kernels take the most device time; every
kernel's row goes to outputs/profile_<family>.json (ignored by git).
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAMILIES = [  # first match wins
    ("warp kernel", ("warp_bilinear_nhwc",)),
    ("deform kernel", ("deform_conv_nhwc",)),
    ("layout (NCHW<->NHWC)", ("nchwToNhwc", "nhwcToNchw", "permute")),
    # cuDNN's FFT convolutions run as DSE::*fft* and region_transform kernels
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "winograd", "fprop",
                     "fft", "region_transform")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
    ("copy", ("memcpy", "memset", "copy", "cat")),
    ("gather / index", ("gather", "index", "searchsorted")),
]


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other elementwise / reduction"


def main() -> int:
    import argparse

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--family", default="lhbdc", choices=(
        "lhbdc", "flowguided_b", "deform_b", "flexrate", "dmc", "elic", "eval_lhbdc",
        "eval_flowguided_b", "image_eval", "image_eval_bf16"))
    codec = parser.parse_args().family
    sys.path.insert(0, ROOT)
    import bench_torch
    import chip_smoke
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.ops.precision import policy_from_name, set_deterministic

    set_deterministic()  # as every CLI and coder does: TF32 off, fixed algorithms

    dtype = "bfloat16"
    closers = [parallel.shutdown]
    if codec == "dmc":
        from tpuvc_torch.data.uvg import SyntheticSequence, device_frame
        from tpuvc_torch.models.dmc import PFrameDMCCoder

        coder = PFrameDMCCoder(chip_smoke.dmc_model(torch))
        closers.append(coder.close)
        src = SyntheticSequence(n_frames=5, h=1088, w=1920)
        xs = [device_frame(src.u8(i), "cuda") for i in range(5)]
        dpb0 = {"ref_frame": xs[0], "ref_feature": None, "ref_down_ratio": 1.0}
        batch, n_real, dtype = 1, len(xs) - 1, "float32"

        def code_window():
            dpb, futs = dpb0, []
            for x in xs[1:]:
                fut, dpb = coder.encode_async(x, dpb)
                futs.append(fut)
            return [f.result() for f in futs]

        def decode_window(bits):
            return coder.decode_sequence(dpb0, bits)
    elif codec.startswith("eval_"):
        import contextlib
        import io

        from tpuvc_torch.cli import test as eval_cli
        from tpuvc_torch.config import TestConfig, apply_overrides
        from tpuvc_torch.eval.infographic import TestInfographic

        cfg = apply_overrides(TestConfig(), chip_smoke.eval_overrides(
            codec[len("eval_"):], os.path.join(ROOT, "outputs")))
        with chip_smoke.cli_heads_seeded():
            intra, model = eval_cli.build_models(cfg)
        intra, model = intra.cuda().eval(), model.cuda().eval()
        batch = cfg.max_batch if cfg.level_batched else 1
        n_real, dtype = sum(cfg.dataset.sequences.values()), cfg.compute_dtype

        def code_window():
            with contextlib.redirect_stdout(io.StringIO()):
                return eval_cli._run_levels(cfg, intra, model, TestInfographic(),
                                            torch.device("cuda"))

        def decode_window(_):
            return None
    elif codec.startswith("image_eval"):
        from tpuvc_torch.cli.test import make_intra_fn
        from tpuvc_torch.data.kodak import SyntheticImages
        from tpuvc_torch.eval.image_runner import eval_images
        from tpuvc_torch.models.elic import ELIC

        forward = make_intra_fn(ELIC(generator=torch.Generator().manual_seed(0)).cuda().eval())
        images = SyntheticImages(n=3, h=512, w=768)
        batch, n_real = 1, len(images)
        dtype = "bfloat16" if codec.endswith("bf16") else "float32"

        def code_window():
            with torch.inference_mode():
                return eval_images(images, lambda x: forward(torch.from_numpy(x).cuda()))

        def decode_window(_):
            return None
    elif codec == "elic":
        from tpuvc_torch.data.uvg import SyntheticSequence, device_frame
        from tpuvc_torch.models.elic import ELIC, ELICCoder

        intra = ELICCoder(ELIC(generator=torch.Generator().manual_seed(0)))
        src = SyntheticSequence(n_frames=33, h=1088, w=1920)
        x = torch.cat([device_frame(src.u8(i), "cuda") for i in (0, 16, 32)])
        batch = n_real = 3

        def code_window():
            out = intra.compress_batch_async(x)
            intra.synthesize(out["y_hat"])
            return out["strings_resolve"](), out["shape"]

        def decode_window(coded):
            return intra.decompress_batch(*coded)
    else:
        if codec == "lhbdc":
            from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder

            coder = LHBDCCoder(LHBDC(N=128, generator=torch.Generator().manual_seed(0)))
            batch = 4
        elif codec == "flexrate":
            from tpuvc_torch.models.flexrate import FlexRateCoder

            coder = FlexRateCoder(chip_smoke.flexrate_model(torch))
            batch = 4
        elif codec == "deform_b":
            from tpuvc_torch.models.deform_b import DeformBCoder

            coder = DeformBCoder(chip_smoke.v3_model(torch))
            batch = 2
        else:
            from tpuvc_torch.models.flowguided_b import FlowGuidedBCoder

            coder = FlowGuidedBCoder(chip_smoke.v4_model(torch))
            batch = 2
        window, decode_window, _, n_real = bench_torch.bench_window(
            torch, coder, B=batch, family=codec
        )

        def code_window():
            return window()[0]
    smi = bench_torch.nvidia_smi()
    try:
        with policy_from_name(dtype):
            decode_window(code_window())  # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                t0 = time.perf_counter()
                bits = code_window()
                torch.cuda.synchronize()
                t_enc = time.perf_counter() - t0
                t0 = time.perf_counter()
                decode_window(bits)
                torch.cuda.synchronize()
                t_dec = time.perf_counter() - t0
    finally:
        for close in closers:
            close()

    def dev_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(
            evt, "self_cuda_time_total", 0.0
        )

    kernels = [
        e for e in prof.key_averages()
        if dev_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    fams: dict[str, float] = {}
    for e in kernels:
        fams[family(e.key)] = fams.get(family(e.key), 0.0) + dev_us(e) / 1e3
    wall_ms = 1e3 * (t_enc + t_dec)
    print(json.dumps({
        "card": smi, "codec": codec, "batch": batch, "frames": n_real, "compute_dtype": dtype,
        "encode_wall_ms": 1e3 * t_enc,
        "decode_wall_ms": 1e3 * t_dec, "device_kernel_ms": total_ms,
        "device_busy_share": total_ms / wall_ms,
        "note": "profiled run; the profiler adds host overhead",
    }), flush=True)
    print(json.dumps({"device_ms_by_family": dict(
        sorted(fams.items(), key=lambda kv: -kv[1]))}), flush=True)
    rows = [
        {"kernel": e.key, "family": family(e.key), "calls": e.count,
         "device_ms": dev_us(e) / 1e3}
        for e in sorted(kernels, key=dev_us, reverse=True)
    ]
    for r in rows[:25]:
        print(json.dumps({**r, "kernel": r["kernel"][:120]}), flush=True)
    # The convolution ops by shape: device time of the kernels each launched.
    convs = sorted(
        (e for e in prof.key_averages(group_by_input_shape=True)
         if e.key == "aten::cudnn_convolution"),
        key=lambda e: getattr(e, "device_time_total", 0.0), reverse=True,
    )
    for e in convs[:10]:
        ms = getattr(e, "device_time_total", 0.0) / 1e3
        print(json.dumps({"conv_input_shapes": str(e.input_shapes)[:160], "calls": e.count,
                          "device_ms": ms}), flush=True)
    out_dir = os.path.join(ROOT, "outputs")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{codec}.json"), "w") as f:
        json.dump({"card": smi, "kernels": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
