"""The readings a cell's correctness limits are set from, on the card.

    python3 benchmark/control.py --workload lhbdc.code --seeds 1,2,3

For each seed, one sequence of the cell's traffic (the one the seed's
sampler would pick first) is coded twice at the cell's own size: by the
program, through the same call and taps the timed window uses, and by the
lower-precision control (the plain reference with fp8 operands where the
configuration states bfloat16, TF32 where it states float32) in the
program's place. The plain reference then follows each step by step, and
both readings are printed, one JSON line per seed and side. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(cell, seed: int, device, control: bool) -> dict:
    import torch

    from harness import compare, frames, program
    from harness import weights as W

    cfg, mix = cell.cfg, cell.mix
    seqs = frames.make(mix, seed, device)
    seq = seqs[0]
    t0 = time.perf_counter()
    if control:
        rec, kept = compare.control_run(cell.models, cfg, mix, seed, device, seq)
        roles = compare.reference_roles
    else:
        weights = W.states(cell.models.reference(cfg, seed, device))
        prog = program.PROGRAMS[mix["kind"]](cfg, mix, weights, device)
        del weights
        with compare.program_tap(prog, seq, seed) as listen:
            if mix["kind"] == "code":
                _, rec = prog.encode(seq)
            else:
                prog.eval(seq, keep=True)
                rec = {i: t[0].cpu() for i, t in prog.kept.items()}
        kept, roles = listen.kept, prog.roles
        del prog
    gc.collect()
    torch.cuda.empty_cache()
    stages: dict = {}
    out = compare.step_numbers(cell.models, cfg, mix, seed, device, seq, rec, kept, roles,
                               stages)
    out.update(seed=seed, side="control" if control else "program",
               seconds=time.perf_counter() - t0, stages=stages)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--sides", default="program,control")
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    import torch

    from harness import core

    device = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload, ROOT)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for side in args.sides.split(","):
            row = readings(cell, seed, device, side == "control")
            row["workload"] = args.workload
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
