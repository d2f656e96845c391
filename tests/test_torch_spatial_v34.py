"""The H-sharded forwards of FlowGuidedB (v4) and DeformB (v3)
(tpuvc_torch.parallel.spatial) in 4-rank gloo groups on the CPU
(tests/torch_mesh_worker.py's ``spatial_v34`` case), against tpuvc's
unsharded forward on the same weights, and the deform's row offset.

- ``deform_plain(..., y0)``: output rows [y0, y0 + rows) from offsets and
  masks of those rows equal those rows of the whole-frame deform within
  2e-6 (its per-tap contraction may block its sums by row count), at the
  v4 and v3 group shapes, an odd y0, one row, all rows and rows that end
  at the frame's last; rows outside the frame are refused;
- the checkerboard masks of rows [y0, y0 + h) are those rows of the
  frame's masks (an odd y0 flips them);
- at 192x128 the /16 latents' 12 rows start at 0, 3, 6 and 9 over four
  ranks, so half the ranks hold rows that start at an odd row: FlowGuidedB
  at down ratio 1 and 4 (4 pads the pooled frame with zero rows) and
  DeformB, H-sharded, match tpuvc's unsharded forward at tpuvc's bars for
  its sharded forward (tests/test_scheduler.py::TestSpatialSharding): x_hat
  within 2e-4, sizes within 2e-4 relative; every rank launches each deform
  conv for its own rows, and some taps sample another rank's rows;
- a one-rank ``spatial_forward`` is the model's forward bit for bit.

The weights are numpy-seeded flax trees (tests/torch_params_common.py)
carried over by ``params_from_jax``, the flow and offset heads seeded too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import V34_FRAME, V34_RUNS, spatial_frames, start_ranks, v34_model
from torch_params_common import V4_KW, filled_params
from tpuvc.models import deform_b as jd
from tpuvc.models import flowguided_b as jf
from tpuvc.parallel import mesh as jmesh
from tpuvc_torch.ops import checkerboard
from tpuvc_torch.ops.deform import deform_conv2d, deform_plain
from tpuvc_torch.parallel import spatial as S
from tpuvc_torch.parallel.mesh import make_mesh
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RANKS = 4
BAR = 2e-4  # tpuvc's TestSpatialSharding bars: x_hat absolute, sizes relative
V3_KW = dict(feature_channels=(8, 16, 24), N=32, M=32, levels=3, groups=(4, 4, 8, 16))
HEADS = {  # seeded heads: fractional flows and offsets of a few px
    "flowguided_b": {"params/flow_estimator/SubpelConv_3": 1.0,
                     **{f"params/offset_compressor/g_o{i}/Conv_1": 0.05 for i in (1, 2, 3)}},
    "deform_b": {f"params/offset_compressor/g_o{i}/Conv_1": 1.0 for i in (1, 2, 3)},
}
RUN_IDS = [f"{f}-r{kw.get('down_ratio', 1)}" for f, kw in V34_RUNS]


def _jax_module(family):
    return jf.FlowGuidedB(**V4_KW) if family == "flowguided_b" else jd.DeformB(**V3_KW)


def _jax_params(family):
    jm, x = _jax_module(family), jnp.zeros((1, 64, 64, 3))
    args = (1, 0.5, -0.5, 1) if family == "flowguided_b" else (1,)
    return filled_params(lambda: jm.init(jax.random.key(0), x, x, x, *args, "dequantize"),
                         seed=0, scale=HEADS[family])


def _jax_forward(family, kw):
    jm = _jax_module(family)
    if family == "flowguided_b":
        return jax.jit(lambda v, b, c, a: jm.apply(v, b, a, c, kw["s"], 0.5, -0.5,
                                                   kw["down_ratio"], "dequantize"))
    return jax.jit(lambda v, b, c, a: jm.apply(v, b, a, c, kw["s"], "dequantize"))


@pytest.fixture(scope="module")
def v34(tmp_path_factory):
    """(flax parameters and port state dicts by family, tpuvc's unsharded
    forward of each V34_RUNS run, the 4 ranks' results). The ranks run
    while JAX compiles."""
    params = {f: _jax_params(f) for f in ("flowguided_b", "deform_b")}
    states = {f: params_from_jax(jax.tree.map(np.asarray, v)) for f, v in params.items()}
    tmp = tmp_path_factory.mktemp("spatial_v34")
    torch.save({"state": states}, tmp / "inputs.pt")
    wait = start_ranks("spatial_v34", tmp, world=RANKS)
    frames = tuple(map(jnp.asarray, spatial_frames(*V34_FRAME)))
    refs = {}
    for family, kw in V34_RUNS:
        out = _jax_forward(family, kw)(params[family], *frames)
        refs[(family, kw.get("down_ratio"))] = {k: np.asarray(out[k])
                                                for k in ("x_hat", "sizes", "size")}
    return params, states, refs, wait(300)


@pytest.mark.parametrize("run", V34_RUNS, ids=RUN_IDS)
def test_v34_forward_matches_tpuvc_unsharded(v34, run):
    family, kw = run
    key = (family, kw.get("down_ratio"))
    ref = v34[2][key]
    ranks = [out[key] for out in v34[3]]
    H, W = V34_FRAME
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["x_hat"].numpy(), ref["x_hat"], atol=BAR, rtol=0)
        np.testing.assert_allclose(out["sizes"].numpy(), ref["sizes"], rtol=BAR)
        np.testing.assert_allclose(float(out["size"]), float(ref["size"]), rtol=BAR)
        lo, hi = S.rows_of(H, RANKS, r)
        assert out["rows"] == (1, hi - lo, W, 3)
        assert float(out["bits"]) == float(ranks[0]["bits"])  # every rank holds the totals


@pytest.mark.parametrize("run", V34_RUNS, ids=RUN_IDS)
def test_v34_deform_runs_at_each_ranks_rows(v34, run):
    """Each rank computes every deform conv (three fusions for v4, six
    alignments for v3) for its own rows, at y0 its first row; ranks 1-3
    at y0 > 0. The latents' shards start at odd rows on ranks 1 and 3; some
    deform taps sample another rank's rows; v4 warps each level twice."""
    family, kw = run
    key = (family, kw.get("down_ratio"))
    assert [S.rows_of(V34_FRAME[0] // 16, RANKS, r)[0] for r in range(RANKS)] == [0, 3, 6, 9]
    for r, out in enumerate(v34[3]):
        st = out[key]["stats"]
        assert len(st.deforms) == (3 if family == "flowguided_b" else 6)
        assert [d[0] for d in st.deforms] == [S.rows_of(d[2], RANKS, r)[0] for d in st.deforms]
        assert r == 0 or min(d[0] for d in st.deforms) > 0
        assert len(st.warps) == (6 if family == "flowguided_b" else 0)
        assert st.bytes_fetched > 0
    assert sum(out[key]["stats"].taps_elsewhere for out in v34[3]) > 0


@pytest.mark.parametrize("run", V34_RUNS, ids=RUN_IDS)
def test_one_rank_spatial_forward_is_the_model_forward(v34, run, monkeypatch):
    """A mesh of one (no group): the sharded forward is the model's forward
    bit for bit; modes other than 'dequantize' are refused."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    family, kw = run
    mesh = make_mesh(device="cpu")
    model = v34_model(family, v34[1][family])
    xb, xc, xa = (torch.from_numpy(x) for x in spatial_frames(*V34_FRAME))
    with torch.no_grad():
        if family == "flowguided_b":
            ref = model(xb, xa, xc, kw["s"], 0.5, -0.5, kw["down_ratio"], "dequantize")
        else:
            ref = model(xb, xa, xc, kw["s"], "dequantize")
    rows = S.shard_spatial(mesh, (xb, xc, xa))
    out = S.spatial_forward(mesh, model, *rows, **kw)
    assert torch.equal(out["x_hat"].x, ref["x_hat"])
    assert torch.equal(out["sizes"], ref["sizes"])
    assert torch.equal(out["size"], ref["size"]) and torch.equal(out["rate"], ref["rate"])
    with pytest.raises(ValueError, match="dequantize"):
        S.spatial_forward(mesh, model, *rows, mode="ste", **kw)


def test_spatial_forward_refuses_a_family_it_does_not_shard():
    mesh = make_mesh(device="cpu")
    x = S.Rows(torch.zeros((1, 4, 4, 3)), 4)
    with pytest.raises(TypeError, match="Linear"):
        S.spatial_forward(mesh, torch.nn.Linear(1, 1), x, x, x)


def _deform_inputs(G, Cg, Og, H=23, W=17, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, H, W, G * Cg)).astype(np.float32)
    off = (6 * rng.standard_normal((2, H, W, G * 18))).astype(np.float32)
    masks = rng.random((2, H, W, G * 9), dtype=np.float32)
    weight = (rng.standard_normal((G * Og, Cg, 3, 3)) / np.sqrt(9 * Cg)).astype(np.float32)
    bias = rng.standard_normal(G * Og).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, off, masks, weight, bias)]


@pytest.mark.parametrize("G,Cg,Og", [(16, 8, 4), (8, 4, 4)], ids=["v4_groups", "v3_groups"])
@pytest.mark.parametrize("y0,rows", [(0, 23), (7, 5), (0, 1), (22, 1), (13, 10), (4, 19)])
def test_deform_plain_rows_match_the_whole_frame(G, Cg, Og, y0, rows):
    """Rows [y0, y0 + rows) of deform_plain from offsets and masks of those
    rows, and deform_conv2d's on CPU tensors, against the whole frame's."""
    x, off, masks, weight, bias = _deform_inputs(G, Cg, Og, seed=y0 + rows)
    full = deform_plain(x, off, masks, weight, bias, G)
    part = [t[:, y0:y0 + rows].contiguous() for t in (off, masks)]
    got = deform_plain(x, part[0], part[1], weight, bias, G, 3, y0)
    assert got.shape == (2, rows, 17, G * Og)
    torch.testing.assert_close(got, full[:, y0:y0 + rows], rtol=0, atol=2e-6)
    assert torch.equal(deform_conv2d(x, part[0], part[1], weight, bias, G, 3, y0), got)


def test_deform_rows_outside_the_frame_are_refused():
    x, off, masks, weight, bias = _deform_inputs(2, 3, 2, H=8)
    with pytest.raises(ValueError, match="do not fit"):
        deform_plain(x, off[:, :4], masks[:, :4], weight, bias, 2, 3, 5)
    with pytest.raises(ValueError, match="do not fit"):
        deform_conv2d(x, off[:, :4], masks[:, :4], weight, bias, 2, 3, -1)


@pytest.mark.parametrize("y0,h", [(0, 6), (3, 4), (5, 1), (8, 4)])
def test_checkerboard_masks_of_rows_are_those_rows_of_the_frame(y0, h):
    frame = checkerboard.anchor_mask(12, 7)
    assert torch.equal(checkerboard.anchor_mask(h, 7, y0), frame[y0:y0 + h])
    x = torch.from_numpy(np.random.default_rng(h).standard_normal((1, 12, 7, 2)).astype(np.float32))
    for name in ("keep_anchor", "keep_non_anchor"):
        fn = getattr(checkerboard, name)
        assert torch.equal(fn(x[:, y0:y0 + h], y0), fn(x)[:, y0:y0 + h])


@pytest.mark.slow
@pytest.mark.parametrize("run", [V34_RUNS[0], V34_RUNS[2]], ids=[RUN_IDS[0], RUN_IDS[2]])
def test_v34_matches_tpuvcs_sharded_forward(v34, run):
    """tpuvc's own H-sharded forward (shard_spatial over 2 virtual devices,
    XLA's halo exchanges; 192 rows keep at least 2 rows a shard at every
    stride-2 conv, the XLA partitioner's constraint) against the port's
    ranks, at tpuvc's bars."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    family, kw = run
    mesh = jmesh.make_mesh(2)
    fwd = _jax_forward(family, kw)
    with mesh:
        frames = jmesh.shard_spatial(mesh, tuple(map(jnp.asarray, spatial_frames(*V34_FRAME))))
        out = fwd(v34[0][family], *frames)
    for ranks in v34[3]:
        got = ranks[(family, kw.get("down_ratio"))]
        np.testing.assert_allclose(got["x_hat"].numpy(), np.asarray(out["x_hat"]), atol=BAR,
                                   rtol=0)
        np.testing.assert_allclose(got["sizes"].numpy(), np.asarray(out["sizes"]), rtol=BAR)
