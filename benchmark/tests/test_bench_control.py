"""The check that decides ``correct`` can fail.

- The lower-precision control (the reference with fp8 operands where the
  configurations state bfloat16) in the program's place fails the cells'
  limits, at a size a test run holds.
- A run whose timed path is broken underneath comes out not correct, once
  for each fault a codec cell can have: a step that returns its state
  unchanged (a B-frame's reconstruction is its reference), half of a batch
  left out (the second half given the mean of the first half's), and an
  answer altered where it is produced (a block of one reconstruction per
  call zeroed).
- So does one broken upstream, where the decode stays bit-exact: the
  batch's second half coded from the first half's source frames, LHBDC's
  compensation without its flow priors, its residual codec given the frame
  instead of the residual, and latents floored instead of rounded. The cells run on one chip, so there is no exchange between
  chips to leave out. The program runs in float32 here, so that the sound
  run, which must come out correct, reads the reference's values.
"""

import torch
import pytest

from harness import compare, core, frames, program

CPU = torch.device("cpu")
SMALL = dict(frames=17, height=64, width=128, sequences=1)


def _cell(name):
    cell = core.Cell(name)
    cell.mix.update(SMALL)
    return cell


@pytest.mark.parametrize("name", ["lhbdc.code", "lhbdc.eval", "flowguided_b.code"])
def test_the_control_fails_the_limits(name):
    cell = _cell(name)
    lims = compare.limits(cell.root, name)
    assert lims, f"{name} has no limits"
    seed = 2**31 + 3
    seq = frames.make(cell.mix, seed, CPU)[0]
    rec, kept = compare.control_run(cell.models, cell.cfg, cell.mix, seed, CPU, seq)
    values = compare.step_numbers(cell.models, cell.cfg, cell.mix, seed, CPU, seq, rec, kept,
                                  compare.reference_roles)
    if cell.mix["kind"] == "code":
        values["decode_mismatch"] = 0
    values["rerun_mismatch"] = 0
    ok, shown = compare.judge(values, lims)
    assert not ok, shown


def test_a_stage_that_left_no_record_fails():
    """A stage the configuration names that the drawn call never ran (a
    later change that fuses or renames it) fails the check."""
    cell = _cell("lhbdc.code")
    seed = 2**31 + 5
    seq = frames.make(cell.mix, seed, CPU)[0]
    rec, kept = compare.control_run(cell.models, cell.cfg, cell.mix, seed, CPU, seq)
    del kept["B"]["calls"]["residual_compressor.entropy_params"]
    log = {}
    values = compare.step_numbers(cell.models, cell.cfg, cell.mix, seed, CPU, seq, rec, kept,
                                  compare.reference_roles, log)
    assert values["stage_rel_pct"] == float("inf")
    assert log["B:residual_compressor.entropy_params"] == float("inf")


def _state_unchanged(x_hat, refs):
    return refs[0].clone()


def _half_batch(x_hat, refs):
    b = x_hat.shape[0]
    if b < 2:
        return x_hat
    out = x_hat.clone()
    out[b // 2:] = x_hat[: b // 2].mean(dim=0, keepdim=True)
    return out


def _altered(x_hat, refs):
    out = x_hat.clone()
    out[0, :32, :32] = 0.0
    return out


#: Faults on what a B-frame step returns.
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _altered}


def _plant(monkeypatch, fault):
    """Break the B-frame step of the program's timed path: the coder's
    level-batch encode in a code cell, the batched inter forward in an eval
    cell."""
    code_init, eval_init = program.CodeProgram.__init__, program.EvalProgram.__init__

    def code(self, *a, **k):
        code_init(self, *a, **k)
        inner = self.coder.encode_level_batch_async

        def broken(*args, **kw):
            resolve, x_hat = inner(*args, **kw)
            return resolve, fault(x_hat, args)

        self.coder.encode_level_batch_async = broken

    def evaluate(self, *a, **k):
        eval_init(self, *a, **k)
        inner = self.inter_fn

        def broken(r1, r2, xc, idxs, refs):
            x_hat, sizes = inner(r1, r2, xc, idxs, refs)
            return fault(x_hat, (r1, r2)), sizes

        self.inter_fn = broken

    monkeypatch.setattr(program.CodeProgram, "__init__", code)
    monkeypatch.setattr(program.EvalProgram, "__init__", evaluate)


def _second_half_from_first(monkeypatch):
    """The batch's second half coded from the first half's source frames:
    the reconstructions are filed under the right frames, and the decoder,
    which never sees a source, stays bit-exact."""
    def halves(x):
        b = x.shape[0]
        out = x.clone()
        out[b // 2:] = x[: b - b // 2]
        return out

    code_init, eval_init = program.CodeProgram.__init__, program.EvalProgram.__init__

    def code(self, *a, **k):
        code_init(self, *a, **k)
        inner, current = self.coder.encode_level_batch_async, 1
        if self.args.family not in ("lhbdc", "flexrate"):
            current = 2

        def broken(*args, **kw):
            args = list(args)
            args[current] = halves(args[current])
            return inner(*args, **kw)

        self.coder.encode_level_batch_async = broken

    def evaluate(self, *a, **k):
        eval_init(self, *a, **k)
        inner = self.inter_fn
        self.inter_fn = lambda r1, r2, xc, idxs, refs: inner(r1, r2, halves(xc), idxs, refs)

    monkeypatch.setattr(program.CodeProgram, "__init__", code)
    monkeypatch.setattr(program.EvalProgram, "__init__", evaluate)


def _no_flow_prior(monkeypatch):
    """LHBDC's compensation without the flow priors (encoder and decoder
    alike, so the decode stays bit-exact)."""
    from tpuvc_torch.models.lhbdc import LHBDCCoder

    def compensate(self, x_before, x_after, flow_ba, flow_ab, flow_hat):
        size = (x_before.shape[1] // 4, x_before.shape[2] // 4)
        cb, ca = torch.chunk(flow_hat, 2, dim=-1)
        return self.model.motion_compensate(x_before, x_after, cb, ca, size)

    monkeypatch.setattr(LHBDCCoder, "_compensate", compensate)


def _residual_of_the_frame(monkeypatch):
    """LHBDC's encoder codes the frame, not its residual from the
    prediction (the decoder never forms it)."""
    from tpuvc_torch.models.lhbdc import LHBDCCoder

    def res_front(self, x_current, x_pred):
        y, z = self.model.residual_compressor.analysis(x_current)
        return (y, *self.res_coder.quantize_z(z))

    monkeypatch.setattr(LHBDCCoder, "_res_front", res_front)


def _floored_latents(monkeypatch):
    """The hyperprior codecs' symbols floored instead of rounded, in the
    stream and in y_hat alike (so the decode stays bit-exact)."""
    from tpuvc_torch.models import hyperprior

    inner = hyperprior.quantize

    def floored(x, mode, means=None, generator=None):
        if mode != "symbols16":
            return inner(x, mode, means=means, generator=generator)
        c = x if means is None else x - means
        return torch.clamp(torch.floor(c), -32768, 32767).to(torch.int16)

    monkeypatch.setattr(hyperprior, "quantize", floored)


#: Faults upstream of what a step returns, that a decode bit-exact with
#: the encoder cannot show.
UPSTREAM = {"second_half_from_first": _second_half_from_first, "no_flow_prior": _no_flow_prior,
            "residual_of_the_frame": _residual_of_the_frame,
            "floored_latents": _floored_latents}


def _run(name):
    cell = _cell(name)
    cell.cfg["compute_dtype"] = "float32"
    return core.run_cell(cell, 2**32 + 9, 0.05, False, CPU, 0.0)["result"]


@pytest.mark.parametrize("name", ["lhbdc.code", "lhbdc.eval"])
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    if fault is not None:
        _plant(monkeypatch, FAULTS[fault])
    out = _run(name)
    assert out["correct"] == (fault is None), (fault, out["checked"])


@pytest.mark.parametrize("name,fault", [
    ("lhbdc.code", "second_half_from_first"), ("lhbdc.eval", "second_half_from_first"),
    ("lhbdc.code", "no_flow_prior"), ("lhbdc.code", "residual_of_the_frame"),
    ("lhbdc.code", "floored_latents")])
def test_a_fault_upstream_is_not_correct(monkeypatch, name, fault):
    UPSTREAM[fault](monkeypatch)
    out = _run(name)
    assert out["failed"] == 0, "the fault must leave the decode bit-exact"
    assert not out["correct"], (fault, out["checked"])
