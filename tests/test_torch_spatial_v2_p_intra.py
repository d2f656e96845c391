"""The H-sharded forwards of Flex-Rate (v2), DMC (P-frames) and ELIC (intra)
(tpuvc_torch.parallel.spatial) in 4-rank gloo groups on the CPU
(tests/torch_mesh_worker.py's ``spatial_rest`` case), against tpuvc's
unsharded forward on the same weights.

- Flex-Rate (N=32) at 192x128, n=1, l=0.66: the UNets' /16 rows start at
  0, 3, 6, 9 over four ranks and the hyperprior's /64 rows are 1, 1, 1, 0;
  the four ``flexrate`` warps run at each rank's own rows;
- DMC (feat 16, N 32) at 160x192, two chained P-frames: ratio 1.0 (q 0)
  from frame 0 with an empty DPB, then ratio 1.5 (q 1.3) from the first
  frame's sharded DPB, whose antialiased 104 rows are edge-padded to 128.
  The /8 latents' rows start at 0, 5, 10, 15 (the four parts' row parity);
  each frame is judged on its own: tpuvc's second frame starts from the
  ranks' gathered DPB;
- ELIC (N=16, M=24, groups (4, 4, 16)) at 192x128, checkerboard parity at
  odd first rows;
- the bars are tpuvc's for its sharded forward (tests/test_scheduler.py::
  TestSpatialSharding): x_hat within 2e-4, bits and sizes within 2e-4
  relative;
- a one-rank ``spatial_forward`` is the model's forward bit for bit;
- DMC's part masks of a rank's rows.

The weights are numpy-seeded flax trees (tests/torch_params_common.py)
carried over by ``params_from_jax``; Flex-Rate's flow-refinement head is
seeded, so its flows are fractional.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import (
    REST_DMC_CHAIN,
    REST_FRAMES,
    REST_KW,
    REST_RATE,
    rest_frames,
    rest_model,
    start_ranks,
)
from torch_params_common import dmc_params, filled_params
from tpuvc.models import elic as je
from tpuvc.models import flexrate as jf
from tpuvc.parallel import mesh as jmesh
from tpuvc_torch.models.dmc import part_mask
from tpuvc_torch.parallel import spatial as S
from tpuvc_torch.parallel.mesh import make_mesh
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RANKS = 4
BAR = 2e-4  # tpuvc's TestSpatialSharding bars: x_hat absolute, bits relative
FLEXRATE_HEADS = {"params/flow_compressor/g_s_layers_7": 0.1,
                  "params/residual_compressor/g_s_layers_7": 0.1}
RUNS = [("flexrate", 0), ("dmc", 0), ("dmc", 1), ("elic", 0)]
RUN_IDS = ["flexrate", "dmc-ratio1", "dmc-ratio1.5", "elic"]


def _bits64(liks):
    return sum(float(np.sum(-np.log2(np.maximum(np.asarray(p, np.float64), 1e-9))))
               for p in liks)


def _jax_params(family):
    """(flax module, seeded variables) of the family at REST_KW."""
    x = jnp.zeros((1, 64, 64, 3))
    if family == "dmc":
        return dmc_params(seed=6, **REST_KW["dmc"])
    if family == "flexrate":
        jm = jf.BidirFlowRef(**REST_KW["flexrate"])
        return jm, filled_params(lambda: jm.init(jax.random.key(0), x, x, x, 0, 1.0,
                                                 "dequantize"), seed=0, scale=FLEXRATE_HEADS)
    jm = je.ELIC(**REST_KW["elic"])
    return jm, filled_params(lambda: jm.init(jax.random.key(0), x, "dequantize"), seed=1)


def _jax_forward(family, jm, ratio=1.0, q=0.0):
    """tpuvc's 'dequantize' forward of the family's inputs -> {x_hat, bits,
    sizes}; DMC's also returns its DPB."""
    if family == "flexrate":
        def fwd(v, xb, xc, xa):
            out = jm.apply(v, xb, xc, xa, *REST_RATE, "dequantize")
            return {"x_hat": out["x_hat"], "sizes": out["size"], "bits": jnp.sum(out["size"])}
    elif family == "elic":
        def fwd(v, x):
            out = jm.apply(v, x, "dequantize")
            return {"x_hat": out["x_hat"], "liks": out["likelihoods"]}
    else:
        def fwd(v, x, dpb):
            out = jm.apply(v, x, dpb, ratio, "dequantize", q=q)
            return {"x_hat": out["x_hat"], "bits": out["bits"], "dpb": out["dpb"]}
    return jax.jit(fwd)


def _ref(out):
    ref = {k: np.asarray(v) for k, v in out.items() if k in ("x_hat", "bits", "sizes")}
    if "liks" in out:
        ref["bits"] = _bits64(out["liks"].values())
    return ref


@pytest.fixture(scope="module")
def rest(tmp_path_factory):
    """(flax modules and parameters, port state dicts, tpuvc's unsharded
    forward of each run, the 4 ranks' results). The ranks run while JAX
    compiles; DMC's second frame's reference starts from the ranks'
    gathered DPB after the first."""
    params = {f: _jax_params(f) for f in REST_FRAMES}
    states = {f: params_from_jax(jax.tree.map(np.asarray, v)) for f, (_, v) in params.items()}
    tmp = tmp_path_factory.mktemp("spatial_rest")
    torch.save({"state": states}, tmp / "inputs.pt")
    wait = start_ranks("spatial_rest", tmp, world=RANKS)
    refs = {}
    for family in ("flexrate", "elic"):
        jm, v = params[family]
        frames = map(jnp.asarray, rest_frames(family))
        refs[(family, 0)] = _ref(_jax_forward(family, jm)(v, *frames))
    jm, v = params["dmc"]
    xs = [jnp.asarray(x) for x in rest_frames("dmc")]
    (r0, q0), (r1, q1) = REST_DMC_CHAIN
    first = _jax_forward("dmc", jm, r0, q0)(v, xs[1], {"ref_frame": xs[0], "ref_feature": None,
                                                        "ref_down_ratio": 1.0})
    refs[("dmc", 0)] = _ref(first)
    ranks = wait(300)
    dpb = {k: v if k == "ref_down_ratio" else jnp.asarray(v.numpy())
           for k, v in ranks[0][("dmc", 0)]["dpb"].items()}
    refs[("dmc", 1)] = _ref(_jax_forward("dmc", jm, r1, q1)(v, xs[2], dpb))
    refs["dmc_dpb"] = {k: np.asarray(t) for k, t in first["dpb"].items() if k != "ref_down_ratio"}
    return params, states, refs, ranks


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_forward_matches_tpuvc_unsharded(rest, run):
    family, _ = run
    ref = rest[2][run]
    ranks = [out[run] for out in rest[3]]
    H, W = REST_FRAMES[family]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["x_hat"].numpy(), ref["x_hat"], atol=BAR, rtol=0)
        np.testing.assert_allclose(float(out["bits"]), float(ref["bits"]), rtol=BAR)
        if "sizes" in ref:
            np.testing.assert_allclose(out["sizes"].numpy(), ref["sizes"], rtol=BAR)
        lo, hi = S.rows_of(H, RANKS, r)
        assert out["rows"] == (1, hi - lo, W, 3)
        assert float(out["bits"]) == float(ranks[0]["bits"])  # every rank holds the totals


def test_dmc_sharded_dpb_matches_tpuvcs(rest):
    """The first P-frame's DPB gathered from the ranks (the second frame's
    reference) against tpuvc's: every entry, at its shape, within the bar."""
    got = rest[3][0][("dmc", 0)]["dpb"]
    for k, ref in rest[2]["dmc_dpb"].items():
        assert tuple(got[k].shape) == ref.shape, k
        np.testing.assert_allclose(got[k].numpy(), ref, atol=BAR, rtol=0, err_msg=k)
    assert got["ref_down_ratio"] == REST_DMC_CHAIN[0][0]


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_warps_run_at_each_ranks_rows(rest, run):
    """Each rank warps its own rows, at y0 its first row: Flex-Rate's four
    full-frame ``flexrate`` warps, DMC's SPyNet levels and its two
    compensation warps (the 48-channel feature map's among them, at
    feat 16 here); ELIC warps nothing. Some warp samples lie in another
    rank's rows."""
    family, i = run
    H, W = REST_FRAMES[family]
    for r, out in enumerate(rest[3]):
        st = out[run]["stats"]
        assert [w[0] for w in st.warps] == [S.rows_of(w[2], RANKS, r)[0] for w in st.warps]
        assert st.bytes_fetched > 0 and not st.deforms
        if family == "elic":
            assert not st.warps
            continue
        assert r == 0 or min(w[0] for w in st.warps) > 0
        frame_warps = [w for w in st.warps if w[2] == H]
        if family == "flexrate":
            assert len(st.warps) == 4 and {w[4] for w in st.warps} == {3}
        else:
            # two compensation warps; at ratio 1 SPyNet's finest level too
            assert sorted(w[4] for w in frame_warps) == ([3] if i == 0 else []) + [
                3, REST_KW["dmc"]["feat"]]
    assert sum(out[run]["stats"].samples_elsewhere for out in rest[3]) > 0 or family == "elic"


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_one_rank_spatial_forward_is_the_model_forward(rest, run, monkeypatch):
    """A mesh of one (no group): the sharded forward is the model's forward
    bit for bit, DMC's returned DPB too; modes other than 'dequantize' are
    refused."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    family, i = run
    mesh = make_mesh(device="cpu")
    model = rest_model(family, rest[1][family])
    xs = [torch.from_numpy(x) for x in rest_frames(family)]
    rows = S.shard_spatial(mesh, xs)
    with torch.no_grad():
        if family == "flexrate":
            ref = model(*xs, *REST_RATE, "dequantize")
            out = S.spatial_forward(mesh, model, *rows, n=REST_RATE[0], l=REST_RATE[1])
            assert torch.equal(out["size"], ref["size"]) and torch.equal(out["rate"], ref["rate"])
            assert torch.equal(out["x_comp"].x, ref["x_comp"])
        elif family == "elic":
            ref = model(*xs, "dequantize")
            out = S.spatial_forward(mesh, model, *rows)
            assert torch.equal(out["bits"], model.bits(ref["likelihoods"]))
        else:
            dpb, sdpb = {"ref_frame": xs[0]}, {"ref_frame": rows[0]}
            for j, (ratio, q) in enumerate(REST_DMC_CHAIN[:i + 1]):
                ref = model(xs[j + 1], dpb, ratio, "dequantize", q=q)
                out = S.spatial_forward(mesh, model, rows[j + 1], sdpb, ratio=ratio, q=q)
                dpb, sdpb = ref["dpb"], out["dpb"]
            for k in ("bits", "bits_mv", "bits_y", "rate"):
                assert torch.equal(out[k], ref[k]), k
            assert torch.equal(out["warped"].x, ref["warped"])
            for k, v in ref["dpb"].items():
                assert v == out["dpb"][k] if k == "ref_down_ratio" else torch.equal(
                    out["dpb"][k].x, v), k
        assert torch.equal(out["x_hat"].x, ref["x_hat"])
        with pytest.raises(ValueError, match="dequantize"):
            S.spatial_forward(mesh, model, *rows[:1], mode="ste")


@pytest.mark.parametrize("y0,h", [(0, 6), (3, 4), (5, 1), (15, 5)])
def test_part_masks_of_rows_are_those_rows_of_the_frame(y0, h):
    for k in range(4):
        frame = part_mask(20, 7, 6, k)
        assert torch.equal(part_mask(h, 7, 6, k, y0=y0), frame[y0:y0 + h])


@pytest.mark.slow
def test_elic_matches_tpuvcs_sharded_forward(rest):
    """tpuvc's own H-sharded ELIC forward (shard_spatial over 2 virtual
    devices, XLA's halo exchanges) against the port's ranks, at tpuvc's
    bars."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    jm, v = rest[0]["elic"]
    mesh = jmesh.make_mesh(2)
    with mesh:
        x = jmesh.shard_spatial(mesh, tuple(map(jnp.asarray, rest_frames("elic"))))
        ref = _ref(_jax_forward("elic", jm)(v, *x))
    for ranks in rest[3]:
        got = ranks[("elic", 0)]
        np.testing.assert_allclose(got["x_hat"].numpy(), ref["x_hat"], atol=BAR, rtol=0)
        np.testing.assert_allclose(float(got["bits"]), ref["bits"], rtol=BAR)
