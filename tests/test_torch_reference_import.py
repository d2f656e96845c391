"""The port's reference-checkpoint importer against tpuvc's.

The same synthetic reference state dict (``torch_reference_sd``: the
reference models' key space and shapes, buffers and dead parameters
included) goes through ``tpuvc.utils.torch_import`` and
``tpuvc_torch.utils.torch_import``: the trees must be equal leaf for leaf
and the reports must skip and leave unmapped the same keys. The port's
tree then loads strictly into its model, its CLI writes tpuvc's CLI's
bytes, and an imported LHBDC gives tpuvc's forward within PARITY.md's bars
(x_hat <= 2e-5 absolute, bits <= 1e-6 relative). LHBDC and Flex-Rate run
at n=8; ELIC, DeformB and FlowGuidedB at their published widths.
"""

import contextlib
import functools
import hashlib
import io
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_reference_sd as R
from tpuvc.utils import torch_import as J
from tpuvc_torch.utils import torch_import as P
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

NAMES = ["lhbdc", "flexrate", "elic", "deform_b", "icip2023", "flowguided", "icip2024"]
WIDTHS = {"lhbdc": {"n": 8}, "flexrate": {"n": 8}}


@functools.lru_cache(maxsize=None)
def _sd(name):
    return R.STATE_DICTS[name](np.random.default_rng(NAMES.index(name)), **WIDTHS.get(name, {}))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))[:10]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def _model(name):
    if name == "lhbdc":
        from tpuvc_torch.models.lhbdc import LHBDC

        return LHBDC(N=8)
    if name == "flexrate":
        from tpuvc_torch.models.flexrate import BidirFlowRef

        return BidirFlowRef(N=8)
    if name == "elic":
        from tpuvc_torch.models.elic import ELIC

        return ELIC()
    if name == "deform_b":
        from tpuvc_torch.models.deform_b import DeformB

        return DeformB()
    from tpuvc_torch.models.flowguided_b import FlowGuidedB

    return FlowGuidedB()


@pytest.mark.parametrize("name", NAMES)
def test_tree_and_report_match_tpuvc(name):
    sd = _sd(name)
    got, rep = P._IMPORTERS[name](sd)
    want, jrep = J._IMPORTERS[name](sd)
    assert_trees_equal(got, want)
    assert rep.skipped == jrep.skipped
    assert rep.unused(sd) == jrep.unused(sd) == []
    # the dead context_prediction weights and the CDF buffers are skipped
    assert any(k.endswith("._quantized_cdf") for k in rep.skipped)
    if name not in ("lhbdc", "flexrate"):
        assert any("context_prediction." in k for k in rep.skipped)


@pytest.mark.parametrize("name", ["lhbdc", "flexrate", "elic", "deform_b", "flowguided"])
def test_imported_tree_loads_strictly_into_the_port(name):
    params, _ = P._IMPORTERS[name](_sd(name))
    model = _model(name)
    model.load_state_dict(params_from_jax(params), strict=True)


@pytest.mark.parametrize("name", ["lhbdc", "flowguided"])
def test_cli_writes_tpuvc_bytes(name, tmp_path):
    from tpuvc.cli import import_torch as jcli
    from tpuvc_torch.cli import import_torch as pcli

    pth = tmp_path / f"{name}.pth"
    R.save_pth(str(pth), _sd(name), wrap=name == "lhbdc")
    outs = {}
    for tag, cli in (("tpuvc", jcli), ("port", pcli)):
        out = tmp_path / tag / "ckpt.msgpack"
        out.parent.mkdir()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--input", str(pth), "--output", str(out), "--family", name])
        lines = buf.getvalue().splitlines()
        assert lines[-1] == f"wrote {out}"
        outs[tag] = (hashlib.sha256(out.read_bytes()).hexdigest(), lines[:-1])
    assert outs["port"] == outs["tpuvc"]
    assert not any("WARNING" in line for line in outs["port"][1])


def test_load_pth_accepts_the_state_dict_wrapper(tmp_path):
    sd = _sd("lhbdc")
    R.save_pth(str(tmp_path / "raw.pth"), sd)
    R.save_pth(str(tmp_path / "wrapped.pth"), sd, wrap=True)
    raw, rep_raw = P.load_pth(str(tmp_path / "raw.pth"), "lhbdc")
    wrapped, rep = P.load_lhbdc_pth(str(tmp_path / "wrapped.pth"))
    assert_trees_equal(wrapped, raw)
    assert rep.unmapped == rep_raw.unmapped == []
    want, jrep = J.load_lhbdc_pth(str(tmp_path / "wrapped.pth"))
    assert_trees_equal(wrapped, want)
    assert rep.skipped == jrep.skipped


def test_load_pth_refuses_what_tpuvc_refuses(tmp_path):
    """Both packages load with torch.load's defaults (weights only): a
    ``.pth`` that pickles numpy arrays is refused by both."""
    path = str(tmp_path / "numpy.pth")
    torch.save({k: v for k, v in _sd("lhbdc").items()}, path)
    with pytest.raises(pickle.UnpicklingError):
        J.load_pth(path, "lhbdc")
    with pytest.raises(pickle.UnpicklingError):
        P.load_pth(path, "lhbdc")


def _bits64(liks):
    return sum(float(np.sum(-np.log2(np.maximum(np.asarray(p, np.float64), 1e-9))))
               for p in liks)


def test_imported_lhbdc_forward_matches_tpuvc():
    from tpuvc.models.lhbdc import LHBDC as JLHBDC
    from tpuvc_torch.models.lhbdc import LHBDC as TLHBDC

    params, _ = P.import_lhbdc_state_dict(_sd("lhbdc"))
    jm = JLHBDC(N=8)
    tm = TLHBDC(N=8)
    tm.load_state_dict(params_from_jax(params), strict=True)
    tm.eval()
    rng = np.random.default_rng(5)
    base = rng.random((1, 64, 64, 3), dtype=np.float32)
    drift = 0.05 * rng.standard_normal(base.shape).astype(np.float32)
    xb, xc, xa = base, np.clip(base + 0.5 * drift, 0, 1), np.clip(base + drift, 0, 1)

    def fwd(v, xb, xc, xa):
        return jm.apply(v, xb, xc, xa, "dequantize", capture_intermediates=True)

    ref, state = jax.jit(fwd)({"params": params}, *map(jnp.asarray, (xb, xc, xa)))
    inter = state["intermediates"]
    ref_liks = [l for m in ("mv_compressor", "residual_compressor")
                for l in inter[m]["__call__"][0]["likelihoods"].values()]
    liks = []
    hooks = [getattr(tm, m).register_forward_hook(
        lambda mod, args, out: liks.extend(out["likelihoods"].values()))
        for m in ("mv_compressor", "residual_compressor")]
    try:
        with torch.no_grad():
            out = tm(*(torch.from_numpy(x) for x in (xb, xc, xa)), "dequantize")
    finally:
        for h in hooks:
            h.remove()
    assert np.isfinite(out["x_hat"].numpy()).all()
    np.testing.assert_allclose(out["x_hat"].numpy(), np.asarray(ref["x_hat"]), atol=2e-5, rtol=0)
    ref_bits = _bits64(ref_liks)
    assert abs(_bits64(liks) / ref_bits - 1.0) <= 1e-6
    assert abs(float(out["bits"]) / ref_bits - 1.0) <= 1e-6
