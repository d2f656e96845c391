"""The port stands alone: tpuvc_torch imports no JAX, no flax and nothing of
tpuvc, and its entry points never fall back to the CPU quietly.

tests/conftest.py imports JAX into this process, so the import check runs in
a fresh interpreter and inspects ``sys.modules`` there.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "tpuvc_torch"
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuvc")


def test_port_modules_import_without_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_scans_cover_the_mesh_package():
    """tpuvc_torch.parallel is the port's own (tpuvc.parallel imports JAX)."""
    assert {"tpuvc_torch.parallel", "tpuvc_torch.parallel.mesh",
            "tpuvc_torch.parallel.spatial"} <= set(PORT_MODULES)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
                                  ROOT / "tests" / "torch_mesh_worker.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_static_scan_finds_no_forbidden_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_default_device_is_cuda_without_fallback():
    from tpuvc_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()


def test_warp_on_a_non_cpu_tensor_never_runs_the_plain_version():
    """Only a CPU tensor takes warp_plain; any other device goes to the
    kernel wrapper, which launches or raises (here: a meta tensor)."""
    from tpuvc_torch.ops.warp import warp, warp_kernel

    img = torch.empty((1, 8, 8, 3), device="meta")
    flow = torch.empty((1, 8, 8, 2), device="meta")
    for compat in ("exact", "lhbdc", "flexrate"):
        with pytest.raises(ValueError, match="CUDA"):
            warp(img, flow, compat)
    with pytest.raises(ValueError, match="CUDA"):
        warp_kernel(torch.zeros((1, 8, 8, 3)), torch.zeros((1, 8, 8, 2)))


def test_deform_on_a_non_cpu_tensor_never_runs_the_plain_version(monkeypatch):
    """Only a CPU tensor takes deform_plain; any other device goes to the
    kernel wrapper, which launches or raises (here: a meta tensor)."""
    from tpuvc_torch.ops import deform

    def plain(*args, **kwargs):
        raise AssertionError("deform_plain ran on a non-CPU tensor")

    monkeypatch.setattr(deform, "deform_plain", plain)
    x = torch.empty((1, 8, 8, 4), device="meta")
    off = torch.empty((1, 8, 8, 2 * 9 * 2), device="meta")
    weight = torch.empty((6, 2, 3, 3), device="meta")
    for masks in (None, torch.empty((1, 8, 8, 2 * 9), device="meta")):
        with pytest.raises(ValueError, match="CUDA"):
            deform.deform_conv2d(x, off, masks, weight, None, 2)
    cpu = [torch.zeros(t.shape) for t in (x, off, weight)]
    with pytest.raises(ValueError, match="CUDA"):
        deform.deform_kernel(cpu[0], cpu[1], torch.zeros((1, 8, 8, 18)), cpu[2],
                             torch.zeros(6), 2)


def test_bench_torch_defaults_to_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert "metric" not in out.stdout


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            script = tmp_path / "chip_smoke.py"
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
