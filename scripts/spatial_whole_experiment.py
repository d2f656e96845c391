"""Which ops of DMC's H-sharded forward must run whole on every rank
(``tpuvc_torch.parallel.spatial.Spatial.whole``) for the sharded P-frames to
equal the unsharded ones on a CUDA card.

Runs ``chip_smoke.mesh_spatial_forward`` for DMC alone (frame 8 at ratio
1.0, frame 16 at ratio 1.5, 1088x1920, four gloo ranks sharing the card,
every process capped at 10 GiB) once per configuration. Each configuration
puts back the windowed form (each rank computing its rows from the input
rows they need) of the ops the port runs whole that it does not name:

  coarse    SPyNet's blocks at 1/8 of the frame's rows or fewer
  mv        the MV analysis's first conv (10 channels at full resolution)
  frames    the antialiased resizes of the frames (ratio 1.5)
  flow      the flow's bilinear resize back to the frame (ratio 1.5)
  upsample  SPyNet's flow upsampling at each pyramid level

    python3 scripts/spatial_whole_experiment.py [CONFIG ...]

CONFIG joins names with '+' ('none' for every op windowed; 'coarse+mv+
frames+flow+upsample' is the port as it is). Prints one JSON line per
configuration and frame: the latents flipped, x_hat's largest difference,
the bits' relative difference, the bytes fetched and the slowest rank's ms.
``--device cpu --frame 128x192`` rehearses it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

OPS = ("coarse", "mv", "frames", "flow", "upsample")
CONFIGS = ["none", "coarse", "coarse+mv", "coarse+mv+flow", "coarse+mv+frames",
           "coarse+mv+frames+flow", "+".join(OPS)]


def apply(config: str) -> None:
    """Put back the windowed form of each op ``config`` does not name (in
    this process: each rank calls it before its forwards)."""
    from tpuvc_torch.models import layers as L
    from tpuvc_torch.models.dmc import down_size
    from tpuvc_torch.models.spynet import BasicBlock
    from tpuvc_torch.ops.resample import _antialias_matrix, _antialias_matrix_on
    from tpuvc_torch.parallel import spatial as S

    whole = set() if config == "none" else set(config.split("+"))
    if not whole <= set(OPS):
        raise ValueError(f"unknown ops in {config!r}; of {OPS}")
    chip_smoke.SPATIAL_FAMILIES = {"dmc": chip_smoke.SPATIAL_FAMILIES["dmc"]}
    whole_op = S.Spatial.whole

    def maybe_whole(sp, x, fn):
        if isinstance(fn, BasicBlock) and "coarse" not in whole:
            return S.basic_block_forward(sp, fn, x)
        if isinstance(fn, L.Conv) and "mv" not in whole:
            return sp.conv(x, fn)
        return whole_op(sp, x, fn)

    def antialias_rows(sp, x, out_h, out_w):
        """The antialiased resize's output rows from the band of input rows
        their matrix rows reach; the columns on the local rows."""
        m = _antialias_matrix(x.H, out_h)

        def band(a, b):
            cols = np.nonzero(m[a:b].any(axis=0))[0]
            return int(cols[0]), int(cols[-1]) + 1

        def op(win, a, b):
            if a >= b:
                return win[:, :0]
            c0 = band(a, b)[0]
            mh = _antialias_matrix_on(x.H, out_h, win.device, win.dtype)
            return torch.einsum("oh,...hwc->...owc", mh[a:b, c0:c0 + win.shape[1]], win)

        y = sp._windowed(x, out_h, lambda a, b: (np.zeros(0, np.int64) if a >= b
                                                 else np.arange(*band(a, b))), op)
        mw = _antialias_matrix_on(x.x.shape[2], out_w, x.x.device, x.x.dtype)
        return y.map(lambda t: torch.einsum("pw,...hwc->...hpc", mw, t))

    def estimate_mv(sp, m, x, ref, ratio):
        if ratio == 1.0:
            return S.spynet_forward(sp, m.optic_flow, x, ref)
        H, W = x.H, x.x.shape[2]
        h, w = down_size(H, W, ratio)
        down = [sp.resize_antialias(t, h, w) if "frames" in whole
                else antialias_rows(sp, t, h, w) for t in (x, ref)]
        xd, rd = (sp.pad_to_multiple(t, 64, mode="edge")[0] for t in down)
        mv = sp.unpad(S.spynet_forward(sp, m.optic_flow, xd, rd), (h, w))
        mv = (sp.whole(mv, lambda t: S.bilinear_resize(t, H, W)) if "flow" in whole
              else sp.resize(mv, H, W))
        return mv.map(lambda t: t * (W / w))

    S.Spatial.whole = maybe_whole
    S.estimate_mv = estimate_mv
    if "upsample" not in whole:
        S.Spatial.upsample2x_flow = lambda sp, f: sp.resize(
            f, 2 * f.H, 2 * f.x.shape[2], align_corners=True).map(lambda t: t * 2.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", default=CONFIGS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frame", default="x".join(map(str, chip_smoke.FRAME)), help="HxW")
    args = ap.parse_args(argv)
    frame = tuple(int(v) for v in args.frame.split("x"))
    cuda = args.device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            print("spatial_whole_experiment: no CUDA device", file=sys.stderr)
            return 2
        from bench_torch import nvidia_smi
        from tpuvc_torch.ops.precision import set_deterministic

        set_deterministic()
        chip_smoke.build_kernels()
        print(json.dumps({"card": nvidia_smi()}), flush=True)
    logged = chip_smoke.log_launches() if cuda else {"warp": set(), "deform": set()}
    ranks_script = chip_smoke.MESH_SPATIAL_IN_RANKS
    chip_smoke.SPATIAL_FAMILIES = {"dmc": chip_smoke.SPATIAL_FAMILIES["dmc"]}
    rows = []
    chip_smoke.emit = rows.append  # keep mesh_spatial_forward's rows
    for config in args.configs:
        chip_smoke.MESH_SPATIAL_IN_RANKS = (
            "import sys\nsys.path.insert(0, 'scripts')\nimport spatial_whole_experiment\n"
            f"spatial_whole_experiment.apply({config!r})\n" + ranks_script)
        rows.clear()
        with tempfile.TemporaryDirectory() as tmp:
            try:
                chip_smoke.mesh_spatial_forward(torch, logged, tmp, args.device, frame)
            except AssertionError:
                pass  # the comparison is the result
        for r in rows:
            if r.get("ranks", "").endswith("sharded vs unsharded"):
                print(json.dumps({
                    "config": config, "run": r["run"], "frame": r["frame"],
                    "latents_flipped": r["latents_flipped"],
                    "latents_flipped_total": sum(r["latents_flipped"].values()),
                    "x_hat_max_abs_diff": r["x_hat_max_abs_diff"],
                    "bits_rel_diff": r["bits_rel_diff"],
                    "bytes_fetched_per_forward": r["bytes_fetched_per_forward"],
                    "forward_ms_slowest_rank": r["forward_ms_slowest_rank"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
