"""The harness as a whole: it refuses to run without a card, a new
configuration, traffic mix and per-layer metric are new files that it
finds by name and runs, nothing it runs imports JAX or the JAX package,
and the reference imports nothing of the program."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import core, frames

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "tpuvc"}


def _imports(path: Path) -> set:
    """Top-level names of the modules ``path`` imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    # whole top-level names: tpuvc_torch is the port, tpuvc the JAX package
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & BANNED), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not (_imports(path) & {"tpuvc_torch", "harness"}), path


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "lhbdc.code",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode != 0
    assert "CUDA card" in r.stderr
    assert not any(line.startswith("{") for line in r.stdout.splitlines())


def test_frames_are_the_seed_s_and_move_by_fractions():
    mix = json.loads((BENCH / "traffic" / "code_2gop.json").read_text())
    mix.update(frames=5, height=64, width=96, sequences=2)
    a = frames.make(mix, 2**31 + 7, torch.device("cpu"))
    b = frames.make(mix, 2**31 + 7, torch.device("cpu"))
    c = frames.make(mix, 2**31 + 8, torch.device("cpu"))
    assert all(np.array_equal(x.frames, y.frames) for x, y in zip(a, b))
    assert not np.array_equal(a[0].frames, c[0].frames)
    assert a[0].u8(0).shape == (1, 64, 96, 3) and a[0].u8(0).dtype == np.uint8
    assert len(a[0]) == 5 and tuple(a[0].size) == (64, 96)
    # every frame moved, and the motion is not whole pixels
    for seq in a:
        assert all(not np.array_equal(seq.u8(i), seq.u8(i + 1)) for i in range(4))
    plan = frames._motion(np.random.default_rng(3), 4, mix)
    speeds = [v for p in plan for v in p["v"]] + [v for p in plan for q in p["patches"]
                                                   for v in q["v"]]
    assert all(abs(v - round(v)) > 1e-3 for v in speeds)
    # every seed gets the same set of pan speeds
    pans = sorted(float(np.hypot(*p["v"])) for p in plan)
    assert pans == pytest.approx(sorted(mix["pan_px"]))


def _tiny_checkout(tmp_path: Path) -> Path:
    """A copy of BENCHMARK.json and benchmark/, to which a configuration,
    a mix, a metric and limits are added as new files, with entries."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    base = root / "benchmark"
    cfg = json.loads((base / "configs" / "lhbdc.json").read_text())
    cfg.update(name="lhbdc_tiny", compute_dtype="float32", model={"N": 16, "rate_id": 845},
               intra={"N": 16, "M": 24, "groups": [4, 4, 16]},
               cli=["--family", "lhbdc", "--l", "845", "--N", "16", "--intra_N", "16",
                    "--intra_M", "24", "--intra_groups", "4,4,16"])
    (base / "configs" / "lhbdc_tiny.json").write_text(json.dumps(cfg))
    (base / "models" / "lhbdc_tiny.py").write_text(
        (base / "models" / "lhbdc.py").read_text())
    mix = json.loads((base / "traffic" / "code_2gop.json").read_text())
    mix.update(frames=5, gop=4, height=64, width=64, sequences=2)
    (base / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (base / "metrics" / "frames_per_call.encode.py").write_text(
        "def read(run):\n"
        "    p = run.phases.get('encode')\n"
        "    return p['frames'] / p['calls'] if p else None\n")
    (base / "limits").mkdir(exist_ok=True)
    (base / "limits" / "lhbdc_tiny.tiny.json").write_text(json.dumps(
        {"limits": {"decode_mismatch": 0, "rerun_mismatch": 0, "intra_rms": 1e-3,
                    "inter_rms": 1e-3, "stage_rel_pct": 0.01, "latent_flip_pct": 0.01}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lhbdc_tiny", "source": "test", "reduced": ["N"],
                             "file": "benchmark/configs/lhbdc_tiny.json", "why": "test"})
    bench["workloads"].append({"name": "lhbdc_tiny.tiny", "config": "lhbdc_tiny",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("encode_fps", "decode_fps"):
            m["workloads"].append("lhbdc_tiny.tiny")
    bench["per_layer"].append({"name": "frames_per_call.encode", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "whole step", "moves": "encode_fps",
                               "workloads": ["lhbdc_tiny.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_new_config_mix_and_metric_are_new_files(tmp_path):
    before = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    root = _tiny_checkout(tmp_path)
    cell = core.Cell("lhbdc_tiny.tiny", root)
    assert [m["name"] for m in cell.per_layer][-1] == "frames_per_call.encode"
    dev = torch.device("cpu")
    out = core.run_cell(cell, 2**33 + 1, 0.05, False, dev, 0.0)["result"]
    assert out["correct"], out["checked"]
    assert set(out["metrics"]) == {"setup_s", "encode_fps", "decode_fps"}
    assert out["attempted"] == 5 and out["failed"] == 0
    traced = core.run_cell(cell, 5, 0.05, True, dev, 0.0)["result"]
    assert traced["metrics"]["frames_per_call.encode"]["value"] == 5
    assert traced["correct"]
    assert list(traced)[-1] == "checked"
    assert core.jax_loaded() == []
    # the files that were there are as they were
    assert all(p.read_bytes() == b for p, b in before.items())
