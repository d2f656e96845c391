"""The ``deform_b`` configuration on the CPU: the frozen reference
(``reference/deform_b.py``) against the program's DeformB at 64x128, float32,
with the benchmark's seeded weights (the offset heads and the gains drawn)
in both, at rate level 1.5; the cell's check on the program's own calls,
and that it fails a broken program and the lower-precision control.

Tolerances: both sides run the same float32 operations in the same order on
the CPU (``F.conv2d``, the plain deform formulation, the same geometric
interpolation of the gains), so the reconstructions agree to 1e-4 (what
the other configurations' reference tests allow for a differing
summation order) and the bits to 1e-5 relative."""

import json
from pathlib import Path

import pytest
import torch

from harness import compare, core, frames
from harness import weights as W
from reference import deform_b as ref_db

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 1e-4
SMALL = dict(frames=17, height=64, width=128, sequences=1)

#: a few threads each: the runs share the machine's cores with the other
#: test workers, and spinning thread teams that outnumber them stall
torch.set_num_threads(2)


def _cfg():
    return json.loads((BENCH / "configs" / "deform_b.json").read_text())


@pytest.fixture(scope="module")
def pair():
    from tpuvc_torch.models.deform_b import DeformB

    cfg = _cfg()
    ref = W.seeded(lambda: ref_db.build(cfg), 14, CPU, heads=cfg["heads"])
    m = cfg["model"]
    with torch.device("meta"):
        prog = DeformB(feature_channels=tuple(m["feature_channels"]), N=m["N"], M=m["M"],
                       levels=m["levels"], groups=tuple(m["groups"]))
    prog.load_state_dict({k: v.clone() for k, v in ref.state_dict().items()},
                         strict=True, assign=True)
    return cfg, ref, prog.eval()


def _frames(seed, b=2):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((b, 64, 128, 3), generator=g) for _ in range(3)]


@torch.no_grad()
def test_likelihood_forward_matches_the_reference(pair):
    cfg, ref, prog = pair
    xb, xc, xa = _frames(1)
    fwd = prog(xb, xa, xc, cfg["model"]["s"], mode="dequantize")
    x_ref, bits, _ = ref_db.b_frame(ref, xb, xc, xa, 4, 0, 8, cfg, "eval")
    assert (fwd["x_hat"] - x_ref).abs().max() <= TOL
    assert float(bits.sum()) == pytest.approx(float(fwd["size"]), rel=1e-5)
    # the drawn gains differ between levels 1 and 2, so s = 1.5 mixes them
    gain = ref.offset_compressor.Gain
    assert not torch.equal(gain[1], gain[2])


@torch.no_grad()
def test_coder_round_trip_at_a_fractional_rate_matches_the_reference(pair):
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import VFrameBitstream
    from tpuvc_torch.models.deform_b import DeformBCoder

    cfg, ref, prog = pair
    xb, xc, xa = _frames(2)
    coder = DeformBCoder(prog, device="cpu")
    try:
        bits, x_prog = coder.encode_level_batch(xb, xa, xc, cfg["model"]["s"])
        streams = [VFrameBitstream.deserialize(b.serialize()) for b in bits]
        dec = coder.decode_level_batch(xb, xa, streams)
    finally:
        parallel.shutdown()
    assert bits[0].s_milli == 1500
    assert torch.equal(dec, x_prog)
    x_ref, _, _ = ref_db.b_frame(ref, xb, xc, xa, 4, 0, 8, cfg, "stream")
    assert (x_prog - x_ref).abs().max() <= TOL
    # the drawn heads give fractional, nonzero offsets
    cond, temp, _, _ = ref.decoder_context(xb, xa)
    fcur = ref.feature_extractor(xc)
    inputs = [torch.cat([c, f], dim=-1) for c, f in zip(cond, fcur)]
    heads = ref.offset_compressor.encode(inputs, cond, temp, cfg["model"]["s"])[0]
    offsets = ref_db.head_to_deform(torch.chunk(heads[0], 2, dim=-1)[0])[0]
    assert float(offsets.abs().max()) > 0.05
    assert not torch.equal(offsets, torch.round(offsets))


def _cell():
    cell = core.Cell("deform_b.code")
    cell.mix.update(SMALL)
    return cell


def _residual_of_the_frame(monkeypatch):
    """DeformB's encoder codes the current frame's features alone, not them
    beside the aligned prediction (the decoder never runs the analysis, so
    it stays bit-exact)."""
    from tpuvc_torch.models.deform_b import DeformBCoder

    def res_inputs(self, fcur, x_comp):
        return tuple(torch.cat([f, torch.zeros_like(xc)], dim=-1) for f, xc in zip(fcur, x_comp))

    monkeypatch.setattr(DeformBCoder, "_res_inputs", res_inputs)


@pytest.mark.parametrize("fault", [None, "residual_of_the_frame"])
def test_the_check_follows_the_program_and_fails_a_fault(monkeypatch, fault):
    """The program in float32 on the CPU reads the reference's values: every
    stage, link and flip 0, and correct. With the residual codec given the
    frame, the decode stays bit-exact and the check fails."""
    if fault is not None:
        _residual_of_the_frame(monkeypatch)
    cell = _cell()
    cell.cfg["compute_dtype"] = "float32"
    out = core.run_cell(cell, 2**32 + 11, 0.05, False, CPU, 0.0)
    result, log = out["result"], out["notes"]["stage_rel_pct"]
    assert result["failed"] == 0, "the decode must stay bit-exact"
    assert result["correct"] == (fault is None), (fault, result["checked"])
    if fault is None:
        assert log and all(v == 0.0 for v in log.values()), log
        assert result["checked"]["latent_flip_pct"][0] == 0.0
    else:
        assert log["B:link.residual_compressor.analysis"] > 5.0


def test_the_control_fails_the_limits():
    cell = _cell()
    lims = compare.limits(cell.root, cell.name)
    seed = 2**31 + 7
    seq = frames.make(cell.mix, seed, CPU)[0]
    rec, kept = compare.control_run(cell.models, cell.cfg, cell.mix, seed, CPU, seq)
    values = compare.step_numbers(cell.models, cell.cfg, cell.mix, seed, CPU, seq, rec, kept,
                                  compare.reference_roles)
    values.update(decode_mismatch=0, rerun_mismatch=0)
    ok, shown = compare.judge(values, lims)
    assert not ok, shown
