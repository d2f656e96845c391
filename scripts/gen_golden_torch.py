"""Regenerate or verify the golden records of tpuvc_torch's CPU streams
(tests/golden/torch_golden.json; cases in tests/torch_golden_common.py).

    python scripts/gen_golden_torch.py           # write the file
    python scripts/gen_golden_torch.py --check   # compare, exit 1 on drift

Each family's record is computed in two separate processes (one CPU
thread each). A family whose two records differ is not written: the
script prints both and exits 1, and the difference is a finding to record
(ROADMAP.md, section C), not a golden. Regenerate only when a change of the
port's stream bytes is deliberate; the file's diff is then its record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(ROOT, "tests", "golden", "torch_golden.json")

_ONE = """
import json, sys
sys.path[:0] = [{root!r}, {tests!r}]
from torch_golden_common import record
print(json.dumps(record(sys.argv[1])))
"""


def run_case(name: str) -> dict:
    """One family's record, computed in a fresh interpreter."""
    code = _ONE.format(root=ROOT, tests=os.path.join(ROOT, "tests"))
    out = subprocess.run([sys.executable, "-c", code, name], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"{name}: {out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--check", action="store_true",
                   help="compare against the committed file instead of writing")
    args = p.parse_args(argv)

    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch

    from torch_golden_common import CASES

    out = {"_backend": "cpu", "_threads": 1, "_torch": torch.__version__}
    unstable = {}
    for name in CASES:
        first, second = run_case(name), run_case(name)
        print(f"{name}: {first}", file=sys.stderr)
        if first != second:
            unstable[name] = (first, second)
        else:
            out[name] = first
    if unstable:
        for name, (a, b) in unstable.items():
            print(f"UNSTABLE {name}: two processes gave\n  {a}\n  {b}")
        return 1

    if args.check:
        with open(PATH) as f:
            expected = json.load(f)
        bad = []
        for name in CASES:
            want = expected.get(name)
            if want is None:
                bad.append(f"{name}: missing from the file")
                continue
            for key in ("stream_sha256", "stream_len"):
                if out[name][key] != want[key]:
                    bad.append(f"{name}.{key}: {out[name][key]} != {want[key]}")
            if abs(out[name]["psnr"] - want["psnr"]) > 1e-3:
                bad.append(f"{name}.psnr: {out[name]['psnr']} != {want['psnr']}")
        if bad:
            print("GOLDEN DRIFT:\n  " + "\n  ".join(bad))
            return 1
        print(f"OK: {len(CASES)} families match {PATH}")
        return 0

    with open(PATH, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
