"""The frozen reference against the program (``tpuvc_torch``) on the CPU
at 64x64, float32, with the benchmark's seeded weights in both: ELIC,
LHBDC and FlowGuidedB, under the coder's stream semantics and the eval's
likelihood semantics, and the reference's assembly of a reconstruction
from the program's own latent."""

import json
from pathlib import Path

import pytest
import torch

from harness import weights as W
from reference import elic as ref_elic
from reference import flowguided_b as ref_fg
from reference import lhbdc as ref_lhbdc

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 1e-4


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _frames(seed, n=3, h=64, w=64):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((1, h, w, 3), generator=g) for _ in range(n)]


def _program(model_cls, ref_model, **kw):
    with torch.device("meta"):
        model = model_cls(**kw)
    model.load_state_dict({k: v.clone() for k, v in ref_model.state_dict().items()},
                          strict=True, assign=True)
    return model.eval()


def _elic():
    icfg = _cfg("lhbdc")["intra"]
    ref = W.seeded(lambda: ref_elic.ELIC(N=icfg["N"], M=icfg["M"], groups=tuple(icfg["groups"])),
                   11, CPU)
    from tpuvc_torch.models.elic import ELIC

    return ref, _program(ELIC, ref, N=icfg["N"], M=icfg["M"], groups=tuple(icfg["groups"]))


@torch.no_grad()
def test_elic_stream_and_eval():
    from tpuvc_torch.models.elic import ELICCoder

    ref, prog = _elic()
    x = _frames(1, n=1)[0]
    coder = ELICCoder(prog, device="cpu")
    out = coder.compress_batch(x)
    x_prog = coder.synthesize(out["y_hat"])
    x_ref, _, lat = ref.encode(x)
    assert (x_prog - x_ref).abs().max() <= TOL
    assert torch.equal(out["y_hat"], lat["intra"])
    # the program's latent, assembled by the reference, gives the program's frame
    x_asm = ref_elic.assemble(ref, {"g_s": [((out["y_hat"],), {}, None)]})
    assert (x_asm - x_prog).abs().max() <= TOL
    fwd = prog(x, "dequantize")
    x_ref, bits, _ = ref.forward_eval(x)
    assert (fwd["x_hat"] - x_ref).abs().max() <= TOL
    prog_bits = sum(-torch.log2(torch.clamp(p, min=1e-9)).sum() for p in fwd["likelihoods"].values())
    assert float(bits.sum()) == pytest.approx(float(prog_bits), rel=1e-5)


@torch.no_grad()
def test_lhbdc_stream_and_eval():
    from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder

    cfg = _cfg("lhbdc")
    ref = W.seeded(lambda: ref_lhbdc.build(cfg), 12, CPU)
    prog = _program(LHBDC, ref, N=cfg["model"]["N"])
    xb, xc, xa = _frames(2)
    coder = LHBDCCoder(prog, device="cpu")
    _, x_prog = coder.encode_recon(xb, xc, xa, rate_id=845)
    x_ref, bits, lat = ref_lhbdc.b_frame(ref, xb, xc, xa, 8, 0, 16, cfg, "stream")
    assert (x_prog - x_ref).abs().max() <= TOL
    fwd = prog(xb, xc, xa, "dequantize")
    assert (fwd["x_hat"] - x_ref).abs().max() <= TOL
    assert float(bits.sum()) == pytest.approx(float(fwd["bits"]), rel=1e-5)


@torch.no_grad()
def test_flowguided_b_stream_and_eval():
    from tpuvc_torch.models.flowguided_b import FlowGuidedB, FlowGuidedBCoder

    cfg = _cfg("flowguided_b")
    ref = W.seeded(lambda: ref_fg.build(cfg), 13, CPU, heads=cfg["heads"])
    m = cfg["model"]
    prog = _program(FlowGuidedB, ref, feature_channels=tuple(m["feature_channels"]), N=m["N"],
                    M=m["M"], levels=m["levels"], groups=tuple(m["groups"]))
    xb, xc, xa = _frames(3)
    s1, s2 = ref_fg.get_scales(4, 0, 8)
    coder = FlowGuidedBCoder(prog, device="cpu")
    _, x_prog = coder.encode_recon(xb, xa, xc, s=m["s"], scale1=s1, scale2=s2, down_ratio=1)
    x_ref, _, lat = ref_fg.b_frame(ref, xb, xc, xa, 4, 0, 8, cfg, "stream")
    assert (x_prog - x_ref).abs().max() <= TOL
    fwd = prog(xb, xa, xc, float(cfg["eval_level"]), s1, s2, 1, "dequantize")
    x_ref, bits, _ = ref_fg.b_frame(ref, xb, xc, xa, 4, 0, 8, cfg, "eval")
    assert (fwd["x_hat"] - x_ref).abs().max() <= TOL
    assert float(bits.sum()) == pytest.approx(float(fwd["size"]), rel=1e-5)
    # the seeded heads give fractional, nonzero flows
    flow = ref.estimate_flow(xb, xa, 1)
    assert float(flow.abs().max()) > 0.05
