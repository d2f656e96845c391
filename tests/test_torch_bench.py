"""bench_torch.py on the CPU at 64x64: it runs bench.py's measurement on the
port end to end (LHBDC(N=128) window, encode, decode, the eval forward) and
prints bench.py's record: every key of bench.py's payload, decode bit-exact,
at least one measured window, an eval fps. A budget too short for the eval
fails the run instead of leaving eval_fps out.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _bench_py_keys():
    """The keys of the record bench.py's ``payload`` builds, read from its
    source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "payload")
    record = next(n for n in ast.walk(fn) if isinstance(n, ast.Dict))
    return {k.value for k in record.keys}


def _run_bench(**env):
    env = dict(os.environ, TPUVC_BENCH_HW="64x64", OMP_NUM_THREADS="2", **env)
    return subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py"), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )


def test_bench_torch_prints_bench_py_record_on_cpu():
    out = _run_bench()
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert lines[0]["device"] == "cpu" and lines[0]["nvidia_smi"] is None
    record = lines[-1]
    keys = _bench_py_keys()
    assert {"metric", "value", "encode_fps", "decode_bit_exact", "measured_windows"} <= keys
    assert keys <= set(record), keys - set(record)
    assert record["metric"] == "lhbdc_1080p_gop16_encdec_fps"
    assert record["decode_bit_exact"] is True
    assert record["measured_windows"] >= 1
    assert record["eval_fps"] > 0 and record["compute_dtype"] == "bfloat16"
    assert record["frame"] == [64, 64] and record["device"] == "cpu"
    # CPU tensors never launch a kernel: the counts of both timed phases are 0
    assert record["launches"] == record["eval_launches"] == {"warp": 0, "deform": 0}
    # every earlier record has the same keys, with fewer windows or no eval
    for line in lines[1:-1]:
        assert keys <= set(line) and line["measured_windows"] <= record["measured_windows"]


def test_bench_torch_fails_when_the_budget_leaves_no_room_for_the_eval():
    out = _run_bench(TPUVC_BENCH_BUDGET_S="1")
    assert out.returncode != 0
    record = json.loads(out.stdout.splitlines()[-1])
    assert "eval_fps" not in record and "eval_fps_skipped" in record
    assert record["decode_bit_exact"] is True and record["measured_windows"] == 2
