"""The port's spans and counters (``tpuvc_torch.obs``): nothing while off,
the parent and root links (through the coders' worker pool too), tracing
on by itself under ``torch.profiler`` on the profiler's clock, the spans
of a level-batched LHBDC encode and decode on the CPU, and the CLIs'
``--trace`` files."""

import json
import sys
import threading
from pathlib import Path

import pytest
import torch

from tpuvc_torch import obs
from tpuvc_torch.coder import container
from tpuvc_torch.coder.parallel import CtxPool

ROOT = Path(__file__).resolve().parents[1]
LHBDC_STAGES = json.loads((ROOT / "benchmark" / "configs" / "lhbdc.json").read_text())["stages"]
SMALL = ["--init", "random", "--N", "32", "--intra_N", "16", "--intra_M", "24",
         "--intra_groups", "4,4,16", "--device", "cpu"]


@pytest.fixture(autouse=True)
def fresh():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def test_off_a_span_is_the_shared_null_context_and_records_nothing():
    a, b = obs.span("encode"), obs.span("inter", level=1, batch=2)
    assert a is b is obs._NULL
    with a:
        obs.count("entropy.rans_bytes", 10)

    @obs.spanned("container")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert obs.records() == []
    assert "entropy.rans_bytes" not in obs.counters()


def test_parent_root_and_a_pool_task_inherit_the_submitter_s_span():
    obs.enable()
    pool = CtxPool(max_workers=2)

    def job():
        with obs.span("entropy.rans"):
            pass

    try:
        with obs.span("decode"):
            with obs.span("inter", level=0, batch=2):
                pool.submit(job).result()
        with obs.span("encode"):
            pass
    finally:
        pool.shutdown()
    recs = {r.name: r for r in obs.records()}
    dec, inter = recs["decode"], recs["inter"]
    assert (dec.parent, dec.root) == (None, dec.id)
    assert (inter.parent, inter.root, inter.attrs) == (dec.id, dec.id, {"level": 0, "batch": 2})
    # the worker's task span hangs under the submitter's, in the same call
    task = recs["task"]
    assert (task.parent, task.root) == (inter.id, dec.id)
    assert task.thread != dec.thread
    # the wait on the future parks the submitter: an entropy wait of the call
    assert (recs["entropy.wait"].parent, recs["entropy.wait"].root) == (inter.id, dec.id)
    rans = recs["entropy.rans"]
    assert (rans.parent, rans.root, rans.thread) == (task.id, dec.id, task.thread)
    enc = recs["encode"]
    assert (enc.parent, enc.root) == (None, enc.id) and enc.id != dec.id
    assert all(r.t0_ns <= r.t1_ns for r in obs.records())


def test_counters_lose_no_update_across_threads():
    obs.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [obs.count("entropy.fetch_bytes", 3)
                                                    for _ in range(2000)])
                   for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert obs.counters()["entropy.fetch_bytes"] == 32 * 2000 * 3


def test_on_under_the_profiler_on_its_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert obs.span("encode") is not obs._NULL
        with obs.span("encode"):
            with obs.span("inter", level=2, batch=4):
                torch.ones(64).sum()
            with obs.span("container"):
                pass
    assert obs.span("encode") is obs._NULL  # off again once the profiler stops
    recs = obs.records()
    assert sorted(r.name for r in recs) == ["container", "encode", "inter"]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("tpuvc.")}
    assert set(events) == {"tpuvc.encode", "tpuvc.inter", "tpuvc.container"}
    for r in recs:
        assert abs(events["tpuvc." + r.name].start_ns() - r.t0_ns) < 1_000_000


def test_stages_are_spanned_in_a_named_model_only():
    from tpuvc_torch.models.hyperprior import MVCompressor
    from tpuvc_torch.models.lhbdc import LHBDC

    obs.enable()
    named = LHBDC(N=16)
    x = torch.zeros(1, 64, 64, 4)
    named.mv_compressor.analysis(x)
    MVCompressor(N=16).analysis(x)  # built alone: no path, no span
    assert [r.name for r in obs.records()] == ["stage.mv_compressor.analysis"]


def _stream_bytes(blob: bytes) -> int:
    """The rANS bytes of a sequence file: every I- and B-frame stream."""
    total = 0
    for typ, _, frame in container.VSequenceBitstream.deserialize(blob).frames:
        if typ == "I":
            total += sum(len(s) for s in container.IFrameBitstream.deserialize(frame).streams)
        else:
            b = container.BFrameBitstream.deserialize(frame)
            total += len(b.mv_y) + len(b.mv_z) + len(b.res_y) + len(b.res_z)
    return total


def test_lhbdc_level_batched_encode_and_decode_spans(tmp_path):
    from tpuvc_torch.cli import decode_v, encode_v

    bin_path, enc_trace, dec_trace = (str(tmp_path / n) for n in
                                      ("s.tpvb", "enc.json", "dec.json"))
    encode_v.main(["--synthetic", "9", "--width", "128", "--height", "64", "--gop", "4",
                   "--level_batched", "--max_batch", "2", "--window_gops", "2",
                   "--bin", bin_path, "--trace", enc_trace] + SMALL)
    decode_v.main(SMALL + ["--bin", bin_path, "--out_dir", str(tmp_path / "dec"),
                           "--trace", dec_trace])
    assert obs.span("encode") is obs._NULL  # --trace switched tracing off again
    stream = _stream_bytes(Path(bin_path).read_bytes())
    seen = set()
    for phase, path in (("encode", enc_trace), ("decode", dec_trace)):
        doc = json.loads(Path(path).read_text())
        spans = doc["spans"]
        roots = [s for s in spans if s["name"] == phase]
        assert len(roots) == 1 and roots[0]["parent"] is None
        rid = roots[0]["id"]
        mine = [s for s in spans if s["root"] == rid]
        names = {s["name"] for s in mine}
        assert {"intra", "inter", "container"} <= names
        assert any(n.startswith("entropy.") for n in names)
        assert {"level", "batch"} <= set(next(s for s in mine if s["name"] == "inter")["attrs"])
        seen |= {n.removeprefix("stage.") for n in names if n.startswith("stage.")}
        # every rANS byte of the phase is the stream's
        assert doc["counters"]["entropy.rans_bytes"] == stream
    assert set(LHBDC_STAGES) <= seen


def test_eval_cli_trace(tmp_path, monkeypatch):
    from tpuvc_torch.cli import test as ttest
    from tpuvc_torch.models.elic import ELIC
    from tpuvc_torch.models.lhbdc import LHBDC

    def small(cfg, seed=0):
        g = torch.Generator().manual_seed(seed)
        return ELIC(N=16, M=24, groups=(4, 4, 16), generator=g), LHBDC(N=16, generator=g)

    monkeypatch.setattr(ttest, "build_models", small)
    path = tmp_path / "eval.json"
    ttest.main(["--device", "cpu", "--trace", str(path), "dataset.name=synthetic",
                'dataset.sequences={"synth": 5}', "dataset.gop=4", "dataset.width=64",
                "dataset.height=64", "model.family=lhbdc", "model.N=16", "levels=(0,)",
                "level_batched=true", f"output_dir={tmp_path}"])
    spans = json.loads(path.read_text())["spans"]
    roots = [s for s in spans if s["name"] == "eval"]
    assert len(roots) == 1
    names = {s["name"] for s in spans if s["root"] == roots[0]["id"]}
    assert {"intra", "inter", "frames.upload", "stage.flownet.forward"} <= names
