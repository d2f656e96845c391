"""Why tpuvc_torch.parallel.spatial computes transposed convs whole, and why
chip_smoke.py caps the device memory of mesh_spatial_forward's processes.

For every Conv, Deconv and CheckerboardConv call of the unsharded forwards
of ``--families`` (FlowGuidedB and DeformB by default; full width, seeded,
chip_smoke's spatial_inputs and spatial_steps: one 1088x1920 B-frame, DMC's
chain of two P-frames, ELIC's I-frame) on a CUDA card:

  windows    each rank's output rows computed from its window (a conv as
             ``Spatial.conv`` cuts it; a transposed conv from the input rows
             its output rows need, unpadded in H) against those rows of the
             whole call: bit for bit, or the largest difference;
  workspace  the device memory the call takes above what was allocated
             before it and its output (cuDNN's workspace), largest first.

    python3 scripts/spatial_conv_audit.py [--cap GIB] [--ranks 4] [--families dmc,elic]

``--cap`` caps this process's device memory as ``mesh_spatial_forward``
does (``chip_smoke.SPATIAL_MEM_GIB``): cuDNN then passes over the plans
whose workspace does not fit. Prints one JSON line per call that differs
and per family a summary. ``--device cpu --frame 128x192`` rehearses it on
the CPU (no workspace there).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tpuvc_torch.models import layers as L  # noqa: E402
from tpuvc_torch.ops.checkerboard import CheckerboardConv  # noqa: E402
from tpuvc_torch.ops.precision import set_deterministic  # noqa: E402
from tpuvc_torch.parallel import spatial as S  # noqa: E402


class Rank(S.Spatial):
    """Rank ``rank`` of ``n`` whose fetches read the whole input (a
    contiguous copy, as ``fetch_rows``' buffer)."""

    def __init__(self, n: int, rank: int):
        super().__init__(types.SimpleNamespace(size=n, rank=rank, group=None, backend="gloo"))

    def fetch(self, x, need):
        idx = torch.as_tensor(need(self.mesh.rank), dtype=torch.long, device=x.x.device)
        return x.x.index_select(1, idx).contiguous()


def window_deconv(d: L.Deconv, x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Output rows [a, b) of ``d(x)`` from the input rows they need."""
    k, s = d.kernel, d.stride
    p = k // 2
    i0 = max(0, -(-(a + p - k + 1) // s))
    i1 = min(x.shape[1], (b - 1 + p) // s + 1)
    y = F.conv_transpose2d(x[:, i0:i1].contiguous().permute(0, 3, 1, 2), d.weight, d.bias,
                           stride=s, padding=(0, p), output_padding=(0, s - 1))
    return y.permute(0, 2, 3, 1)[:, a - i0 * s + p:b - i0 * s + p]


def audit(family: str, n: int, device: str, frame) -> None:
    model, frames = chip_smoke.spatial_inputs(torch, device, frame, family)
    seen, differ, spent = set(), [], []
    cuda = device == "cuda"

    def before(mod, args):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mod._allocated = torch.cuda.memory_allocated()

    def after(name):
        def hook(mod, args, out):
            extra = 0
            if cuda:
                torch.cuda.synchronize()
                extra = (torch.cuda.max_memory_allocated() - mod._allocated
                         - out.numel() * out.element_size())
            x = args[0]
            key = (name, tuple(x.shape))
            if key in seen:
                return
            seen.add(key)
            spent.append((extra / 2**30, name, list(x.shape)))
            diffs = []
            for r in range(n):
                a, b = S.rows_of(out.shape[1], n, r)
                if isinstance(mod, L.Deconv):
                    got = window_deconv(mod, x, a, b)
                else:
                    got = Rank(n, r).conv(S.Rows(x, x.shape[1]), mod).x
                want = out[:, a:b]
                diffs.append(None if torch.equal(got, want)
                             else float((got - want).abs().max()))
            if any(d is not None for d in diffs):
                differ.append({"family": family, "module": name, "kind": type(mod).__name__,
                               "in_shape": list(x.shape), "max_abs_diff_by_rank": diffs})
        return hook

    for name, mod in model.named_modules():
        if isinstance(mod, (L.Conv, L.Deconv, CheckerboardConv)):
            mod.register_forward_pre_hook(before)
            mod.register_forward_hook(after(name))
    with torch.no_grad():
        dpb = None
        for step, (_, kw) in enumerate(chip_smoke.spatial_steps(family)):
            inputs = chip_smoke.spatial_step_inputs(family, step, frames, dpb)
            dpb = chip_smoke.unsharded_forward(model, family, inputs, **kw)["dpb"]
    for row in differ:
        print(json.dumps(row), flush=True)
    spent.sort(reverse=True)
    print(json.dumps({"family": family, "calls": len(seen),
                      "calls_whose_windows_differ": len(differ),
                      "by_kind": {k: sum(r["kind"] == k for r in differ)
                                  for k in ("Conv", "Deconv", "CheckerboardConv")},
                      "largest_workspaces_gib": [[round(g, 3), m, s] for g, m, s in spent[:6]]}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cap", type=float, default=None, help="device memory cap, GiB")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frame", default="x".join(map(str, chip_smoke.FRAME)), help="HxW")
    ap.add_argument("--families", default="flowguided_b,deform_b",
                    help=f"comma-separated, of {','.join(chip_smoke.SPATIAL_FAMILIES)}")
    args = ap.parse_args(argv)
    frame = tuple(int(v) for v in args.frame.split("x"))
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("spatial_conv_audit: no CUDA device", file=sys.stderr)
            return 2
        from bench_torch import nvidia_smi

        set_deterministic()
        if args.cap is not None:
            chip_smoke.cap_device_memory(torch, args.cap)
        print(json.dumps({"card": nvidia_smi(), "cap_gib": args.cap}), flush=True)
    for family in args.families.split(","):
        audit(family, args.ranks, args.device, frame)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
