"""Registers, spills and shared memory of the port's CUDA kernels.

Run from the repository root on a machine with nvcc:

    python3 scripts/kernel_build_report.py [source.cu ...]

Compiles each source (default: every ``tpuvc_torch/csrc/*.cu``) with the
port's own nvcc flags plus ``-Xptxas -v`` into a temporary directory, and
prints one JSON line per compiled kernel: its source, its mangled name,
registers a thread, spill stores and loads in bytes, static shared memory
and stack frame in bytes, as ptxas reports them. Dynamic shared memory is
chosen at launch and is not in this report.
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report(src: str) -> list[dict]:
    sys.path.insert(0, ROOT)
    from tpuvc_torch.utils.native import NVCC_FLAGS, nvcc_path

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", src, "-o",
             os.path.join(tmp, "lib.so")],
            check=True, capture_output=True, text=True,
        )
    rows, name = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            rows.append({"source": os.path.relpath(src, ROOT), "kernel": name})
            continue
        if not rows:
            continue
        row = rows[-1]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            row.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m[1])
            s = re.search(r"(\d+) bytes smem", line)
            row["static_smem_bytes"] = int(s[1]) if s else 0
    return rows


def main() -> int:
    sources = sys.argv[1:] or sorted(glob.glob(os.path.join(ROOT, "tpuvc_torch", "csrc", "*.cu")))
    for src in sources:
        for row in report(os.path.abspath(src)):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
