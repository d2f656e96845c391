"""One run of one cell: set-up, the measured window, the check, the
metrics. Everything a cell needs is found by name:

- ``BENCHMARK.json``: the cell, its configuration and traffic names, the
  metrics and the cells that report them;
- ``benchmark/configs/<config>.json`` and its model file
  ``benchmark/models/<config>.py`` (program side and plain reference);
- ``benchmark/traffic/<traffic>.json``, read by :mod:`harness.frames` and
  the program class its ``kind`` names (:mod:`harness.program`);
- ``benchmark/metrics/<metric>.py``, one reader per per-layer metric;
- ``benchmark/limits/<cell>.json``, the limits of the correctness check.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
import traceback
import zlib
from pathlib import Path

import numpy as np
import torch

from . import compare, frames, program, trace, work
from . import weights as W

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path):
    name = "bench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic,
    model file and metrics, read from the files named after them."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no cell {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name = name
        self.spec = cells[name]
        base = root / "benchmark"
        self.cfg = load_json(base / "configs" / f"{self.spec['config']}.json")
        self.mix = load_json(base / "traffic" / f"{self.spec['traffic']}.json")
        self.models = load_module(base / "models" / f"{self.spec['config']}.py")
        self.end_to_end = [m for m in self.bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in self.bench["per_layer"] if self._reports(m)]
        self.readers = {m["name"]: load_module(base / "metrics" / f"{m['name']}.py")
                        for m in self.per_layer}

    def _reports(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        if cells is not None:
            return self.name in cells
        moved = metric.get("moves")
        if moved is None:
            return True
        return any(m["name"] == moved and self._reports(m) for m in self.bench["end_to_end"])


class Run:
    """What a run measured; the per-layer readers take their numbers from
    it (``benchmark/metrics/<metric>.py``: ``read(run) -> float | None``)."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.phases: dict = {}      # phase -> {"frames", "seconds", "calls", "sequences"}
        self.parts: dict = {}       # "quiet" | "traced" -> the same, for that part of the window
        self.work: dict = {}        # phase -> work.count's per-sequence numbers
        self.trace: trace.Trace | None = None
        self.entropy: trace.EntropyWait | None = None
        self.frames_attempted = 0
        self.frames_failed = 0
        self.decode_mismatch = 0
        self.errors: list = []

    def sequences(self, phase: str, part: str | None = None) -> int:
        book = self.phases if part is None else self.parts.get(part, {})
        return book.get(phase, {}).get("sequences", 0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """Set up, warm up, measure for ``seconds``, check; -> the result line's
    dict (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    ``breakdown``, ``checked``) and earlier lines' extras under ``notes``."""
    cfg, mix = cell.cfg, cell.mix
    run = Run(cell)
    split = {"imports": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        _sync(device)
        now = time.perf_counter()
        split[name] = now - mark
        mark = now

    seqs = frames.make(mix, seed, device)
    lap("frames")
    weights = W.states(cell.models.reference(cfg, seed, device))
    lap("weights")
    prog = program.PROGRAMS[mix["kind"]](cfg, mix, weights, device)
    del weights
    lap("program")
    run.work = work.count(cell.models.pieces(cfg, mix))
    lap("reference_count")

    def step(seq, part: str | None, keep: bool = False) -> dict:
        """One sequence through the mix's phases, counted in the window's
        ``part`` (None: not timed). -> {"output": the host reconstructions
        (code) or the eval's (psnr, sizes), "bad": frames whose decode
        differs from the encoder's reconstruction, and with ``keep`` the
        reconstructions and the tapped calls}."""
        n = len(seq)
        listen = compare.program_tap(prog, seq, seed) if keep else contextlib.nullcontext()
        res = {"bad": 0}
        if mix["kind"] == "code":
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.encode"), listen:
                blob, rec = prog.encode(seq)
            t1 = time.perf_counter()
            with torch.profiler.record_function("bench.decode"):
                dec = prog.decode(blob)
            t2 = time.perf_counter()
            timed = {"encode": t1 - t0, "decode": t2 - t1}
            res["bad"] = sum(1 for i in rec if i not in dec or not torch.equal(dec[i], rec[i]))
            res["output"] = rec
            if keep:
                res["recons"] = rec
        else:
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.eval"), listen:
                res["output"] = prog.eval(seq, keep=keep)
            timed = {"eval": time.perf_counter() - t0}
            if keep:
                res["recons"] = {i: t[0].cpu() for i, t in prog.kept.items()}
                prog.kept = None
        if keep:
            res["kept"] = listen.kept
        if part is not None:
            for phase, dt in timed.items():
                for book in (run.phases, run.parts.setdefault(part, {})):
                    p = book.setdefault(phase, {"frames": 0, "seconds": 0.0, "calls": 0,
                                                "sequences": 0})
                    p["frames"] += n
                    p["seconds"] += dt
                    p["calls"] += 1
                    p["sequences"] += 1
            run.frames_attempted += n
            run.frames_failed += res["bad"]
            run.decode_mismatch += res["bad"]
        return res

    # Warm-up: one whole sequence, every shape the window runs.
    step(seqs[0], None)
    lap("warm_sequence")
    setup_s = time.perf_counter() - t_start

    # The window. A traced run times its first half without the profiler
    # (``mfu`` reads those calls) and traces the second (the device
    # metrics); each half holds one sequence at least.
    prof = spans = None
    if traced and mix["kind"] == "code":
        run.entropy = trace.EntropyWait(prog.coder)
    if device.type == "cuda":
        _launches(reset=True)
    outputs: dict = {}  # sequence -> the digest of the window's first output of it
    part, k, k_traced = "quiet", 0, 0
    w0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - w0
        if traced and part == "quiet" and k > 0 and elapsed >= seconds / 2:
            part, k_traced = "traced", k
            spans = trace.kernel_spans()
            spans.__enter__()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        elif elapsed >= seconds and k > k_traced and (part == "traced" or not traced):
            break
        j = k % len(seqs)
        try:
            out = step(seqs[j], part)["output"]
        except Exception:  # a call that raises fails its frames; the run stops
            run.errors.append(traceback.format_exc(limit=8))
            run.frames_attempted += len(seqs[j])
            run.frames_failed += len(seqs[j])
            break
        if j not in outputs:
            outputs[j] = _digest(out)
        del out
        k += 1
    _sync(device)
    window_wall = time.perf_counter() - w0
    if prof is not None:
        prof.__exit__(None, None, None)
        run.trace = trace.Trace(prof.profiler.kineto_results.events())
        del prof
    if spans is not None:
        spans.__exit__(None, None, None)
    if run.entropy is not None:
        run.entropy.close()

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    checks = {}
    if device.type == "cuda":
        checks["launches"] = _launches()

    # The sampled sequence, drawn from the seed among the window's steps,
    # coded again by the same program object, tapped; its output has to be
    # the window's own.
    picker = np.random.default_rng((seed + 0x5EED) % 2**63)
    sample = None
    values = {"decode_mismatch": run.decode_mismatch} if mix["kind"] == "code" else {}
    values["rerun_mismatch"] = float("inf")
    if k > 0 and not run.errors:
        j = int(picker.integers(k)) % len(seqs)
        try:
            again = step(seqs[j], None, keep=True)
            values["rerun_mismatch"] = again["bad"] + _differ(_digest(again["output"]),
                                                              outputs[j])
            sample = (j, again["recons"], again["kept"])
        except Exception:
            run.errors.append(traceback.format_exc(limit=8))
    roles = prog.roles
    del prog, outputs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # The check, after the window and with the program's state freed.
    stage_log: dict = {}
    if sample is not None:
        j, rec, kept = sample
        values.update(compare.step_numbers(cell.models, cfg, mix, seed, device, seqs[j], rec,
                                           kept, roles, stage_log))
    else:
        values.update({"intra_rms": float("inf"), "inter_rms": float("inf"),
                       "stage_rel_pct": float("inf"), "latent_flip_pct": float("inf")})
    lims = compare.limits(cell.root, cell.name)
    ok, shown = compare.judge(values, lims)
    correct = ok and not run.errors and run.frames_attempted > 0

    metrics = {}
    names = cell.per_layer if traced else cell.end_to_end
    for m in names:
        if traced:
            v = cell.readers[m["name"]].read(run)
        elif m["name"] == "setup_s":
            v = setup_s
        else:
            v = _rate(run, m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.frames_attempted,
              "failed": run.frames_failed, "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        # The traced window is the timed calls: the harness's own work
        # between them (the decode check, the sampler) is no part of it.
        calls = [c for phase in run.phases for c in run.trace.calls(phase)]
        dev["busy_s"] = sum(run.trace.busy(lo, hi) for lo, hi in calls)
        dev["window_s"] = sum(hi - lo for lo, hi in calls)
        result["breakdown"] = run.trace.breakdown(calls)
    result["checked"] = shown
    notes = {"setup_s": setup_s, "setup_split_s": split, "window_wall_s": window_wall, "sequences": k,
             "phases": run.phases, "work_per_sequence": run.work, "errors": run.errors,
             "sample_sequence": None if sample is None else sample[0],
             "parts": run.parts,
             "stage_rel_pct": stage_log, **checks}
    if run.entropy is not None:
        notes["entropy_wait_calls"] = run.entropy.calls
    if run.trace is not None:
        notes["trace"] = {"device_ops": run.trace.device_ops,
                          "launches_matched": run.trace.launches_matched}
    return {"result": result, "notes": notes}


def _digest(output):
    """What the window keeps of a sequence's output, without holding its
    frames (which would make the host allocate afresh inside later calls):
    the CRC-32 of each reconstruction's bytes (code), or the eval's psnr
    and size entries."""
    if isinstance(output, dict):
        return {i: zlib.crc32(memoryview(t.contiguous().numpy().reshape(-1)).cast("B"))
                for i, t in output.items()}
    return [float(v) for part in output for v in part]


def _differ(got, want) -> int:
    """Frames (code) or psnr and size entries (eval) whose digest differs
    between two outputs of one sequence."""
    if isinstance(got, dict):
        return sum(1 for i in set(got) | set(want) if got.get(i) != want.get(i))
    return abs(len(got) - len(want)) + sum(1 for x, y in zip(got, want) if x != y)


def _rate(run: Run, name: str):
    """``<phase>_fps``: all frames of the window's calls of the phase over
    their summed wall time."""
    phase = name.split("_fps")[0]
    p = run.phases.get(phase)
    if not p or p["seconds"] <= 0:
        return None
    return p["frames"] / p["seconds"]


def _launches(reset: bool = False) -> dict:
    """The program's own launch counters of its two hand kernels."""
    from tpuvc_torch.ops import deform, warp

    if reset:
        warp.warp_kernel.launches = deform.deform_kernel.launches = 0
    return {"warp": getattr(warp.warp_kernel, "launches", None),
            "deform": getattr(deform.deform_kernel, "launches", None)}


def jax_loaded() -> list:
    """Top-level modules of JAX or of the JAX package that this process
    has loaded (whole top-level names: ``tpuvc_torch`` is not ``tpuvc``)."""
    banned = {"jax", "jaxlib", "flax", "tpuvc"}
    return sorted({n.split(".")[0] for n in sys.modules} & banned)
