"""Run one cell of the benchmark once, on the card this process finds.

    python3 benchmark/run.py --workload lhbdc.code --seed 12345 --seconds 51 --trace 0

Prints progress and the compared numbers on standard error, earlier lines
(peak memory, kernel launches per frame, the work counted) on standard
output, and as the last line of standard output one JSON object: correct,
attempted, failed, metrics, device (and with ``--trace 1`` breakdown), then
``checked``, each compared number with its limit. Exits non-zero, with no
result, without a CUDA card (or with fewer than the cell asks for), when
the program is missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))

    import torch

    from harness import core

    cell = core.Cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.spec["chips"]:
        print(f"benchmark: cell {args.workload} needs {cell.spec['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import tpuvc_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is missing: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    loaded = core.jax_loaded()
    if loaded:
        print(f"benchmark: the process loaded {loaded}; the port must run without JAX",
              file=sys.stderr)
        return 3
    result, notes = out["result"], out["notes"]
    frames = max(1, result["attempted"])
    launches = notes.get("launches") or {}
    print(json.dumps({"notes": notes, "memory_peak_gib": result["device"]["memory_peak_bytes"] / 2**30,
                      "launches_per_frame": {k: (v / frames if v is not None else None)
                                             for k, v in launches.items()},
                      "power_limit": power_limit()}, default=float))
    for name, (value, limit) in result["checked"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result, default=float))
    sys.stdout.flush()
    return 0


def power_limit() -> str | None:
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() or None


if __name__ == "__main__":
    sys.exit(main())
