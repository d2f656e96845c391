"""The port's spatial sharding (tpuvc_torch.parallel.spatial) in 2- and 4-rank
gloo groups on the CPU (tests/torch_mesh_worker.py), against tpuvc's
``shard_spatial`` on conftest's virtual CPU devices and against the
unsharded ops and forwards.

- ``shard_spatial`` gives each rank the rows of tpuvc's device shards and
  refuses an H the mesh does not divide;
- each sharded op equals its unsharded counterpart on the gathered rows:
  exactly where it moves, pools or selects values (pads, crops, shuffles,
  pools, fetches, the warp), within 2e-6 where it sums products (convs,
  bilinear and antialiased resizes: the same op on a window of other
  height may block its float32 sums otherwise; the deform's plain version may block its per-tap
  contraction by row count). The cases hold 1-row shards under a stride-2
  conv (the case XLA's partitioner miscomputes: held to the unsharded conv,
  not to tpuvc's sharded result), an empty shard (5 rows over 4 ranks), a
  reflected pad that reaches past the neighbouring rank, transposed convs
  (each rank's rows of the whole call: exact), the constant pad, the
  checkerboard conv and masks on shards that start at odd rows, and deform
  offsets that reach past the neighbouring rank and out of the frame;
- the warp of a rank's own rows (``y0``) is bit for bit those rows of the
  whole-frame warp;
- LHBDC(N=16) at 256x192, H-sharded, matches tpuvc's unsharded forward on
  the same weights at tpuvc's own bars for its sharded forward
  (tests/test_scheduler.py::TestSpatialSharding): x_hat within 2e-4,
  sizes within 2e-4 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import run_ranks, spatial_frames, spatial_op_cases
from tpuvc.models.lhbdc import LHBDC as JLHBDC
from tpuvc.parallel import mesh as jmesh
from tpuvc_torch.models.lhbdc import LHBDC
from tpuvc_torch.ops.warp import warp, warp_plain
from tpuvc_torch.parallel import spatial as S
from tpuvc_torch.parallel.mesh import make_mesh
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

WORLDS = (2, 4)
OPS = sorted(spatial_op_cases())
# Ops that sum products; the others move values and must be exact.
SUMMING = ("conv", "subpel", "up2", "upsample", "resize", "deform")
BAR = 2e-4  # tpuvc's TestSpatialSharding bars: x_hat absolute, sizes relative


@pytest.fixture(scope="module", params=WORLDS)
def op_ranks(request, tmp_path_factory):
    return request.param, run_ranks("spatial_ops", tmp_path_factory.mktemp("spatial_ops"),
                                    world=request.param)


@pytest.fixture(scope="module")
def tpuvc_lhbdc():
    """tpuvc's LHBDC(N=16) on flax-initialised weights, its unsharded
    'dequantize' forward on the frames of TestSpatialSharding, and the
    port's state dict of the same weights."""
    jm = JLHBDC(N=16)
    x = jnp.zeros((1, 64, 64, 3))
    v = jax.jit(jm.init, static_argnums=4)(jax.random.key(0), x, x, x, "dequantize")
    xb, xc, xa = map(jnp.asarray, spatial_frames())
    ref = jax.jit(lambda v, b, c, a: jm.apply(v, b, c, a, "dequantize"))(v, xb, xc, xa)
    state = params_from_jax(jax.tree.map(np.asarray, v))
    return jm, v, state, {k: np.asarray(ref[k]) for k in ("x_hat", "x_pred", "sizes", "bits")}


@pytest.fixture(scope="module", params=WORLDS)
def lhbdc_ranks(request, tmp_path_factory, tpuvc_lhbdc):
    tmp = tmp_path_factory.mktemp("spatial_lhbdc")
    torch.save({"state": tpuvc_lhbdc[2]}, os.path.join(tmp, "inputs.pt"))
    return request.param, run_ranks("spatial_lhbdc", tmp, world=request.param)


def _shards(arr):
    """Each device's rows of a placed array, in device order."""
    return [np.asarray(s.data) for s in sorted(arr.addressable_shards, key=lambda s: s.device.id)]


@pytest.mark.parametrize("H,n", [(1088, 4), (17, 4), (5, 4), (320 // 64, 4), (256, 2), (7, 3)])
def test_rows_of_is_one_contiguous_cover(H, n):
    """Every row has exactly one owner, the shards follow in rank order,
    all but the last non-empty ones hold ceil(H/n) rows, and a rank past
    the end owns none (5 rows over 4 ranks: 2, 2, 1, 0)."""
    spans = [S.rows_of(H, n, r) for r in range(n)]
    assert spans[0][0] == 0 and spans[-1][1] == H
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    c = -(-H // n)
    assert all(hi - lo in (0, c) for lo, hi in spans[:-1] if hi < H)
    if (H, n) == (5, 4):
        assert [hi - lo for lo, hi in spans] == [2, 2, 1, 0]


def test_shard_spatial_gives_each_rank_its_devices_rows(op_ranks):
    n, ranks = op_ranks
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    x = np.arange(2 * 8 * 3 * 1, dtype=np.float32).reshape(2, 8, 3, 1)
    placed = jmesh.shard_spatial(jmesh.make_mesh(n), {"x": jnp.asarray(x),
                                                      "y": (jnp.asarray(x + 1),)})
    for r, out in enumerate(ranks):
        got = out["shard_spatial"]
        assert got["x"].H == 8 and got["y"][0].H == 8
        assert np.array_equal(got["x"].x.numpy(), _shards(placed["x"])[r])
        assert np.array_equal(got["y"][0].x.numpy(), _shards(placed["y"][0])[r])


def test_shard_spatial_refuses_an_h_the_mesh_does_not_divide(op_ranks):
    n, ranks = op_ranks
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    with pytest.raises(ValueError, match="divisible"):
        jmesh.shard_spatial(jmesh.make_mesh(n), jnp.zeros((1, 4 * n + 1, 3, 3)))
    for out in ranks:
        assert f"should be divisible by {n}, but it is equal to {4 * n + 1}" in \
            out["shard_spatial_odd"]


@pytest.mark.parametrize("name", OPS)
def test_sharded_op_matches_unsharded(op_ranks, name):
    n, ranks = op_ranks
    for r, out in enumerate(ranks):
        got, want, local_shape, (lo, hi) = out["ops"][name]
        assert got.shape == want.shape
        assert local_shape[1] == hi - lo  # this rank holds its canonical rows
        if name.startswith(SUMMING):
            torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
        else:
            assert torch.equal(got, want), (name, r)


def test_fetch_rows_gathers_any_list_of_rows(op_ranks):
    for out in op_ranks[1]:
        got, want = out["fetch"]
        assert torch.equal(got, want)


@pytest.mark.parametrize("compat", ["exact", "lhbdc", "flexrate"])
@pytest.mark.parametrize("C", [3, 48])
def test_warp_of_a_ranks_rows_is_those_rows_of_the_whole_warp(op_ranks, compat, C):
    n, ranks = op_ranks
    for out in ranks:
        rows, (lo, hi), full = out["warp"][(compat, C)]
        assert rows.shape[1] == hi - lo
        assert torch.equal(rows, full[:, lo:hi])
    # the flows (5 px) cross the shard boundaries of 13 rows
    assert sum(out["stats"].samples_elsewhere for out in ranks) > 0


def test_bits_are_summed_over_the_ranks(op_ranks):
    for out in op_ranks[1]:
        totals, per_sample, want_totals, want_per_sample = out["bits"]
        torch.testing.assert_close(totals, want_totals, rtol=1e-6, atol=0)
        torch.testing.assert_close(per_sample, want_per_sample, rtol=1e-6, atol=0)


@pytest.mark.parametrize("compat", ["exact", "lhbdc", "flexrate"])
@pytest.mark.parametrize("C", [3, 48])
@pytest.mark.parametrize("y0,rows", [(0, 37), (0, 5), (13, 11), (36, 1), (20, 0)])
def test_warp_plain_rows_are_bit_exact(compat, C, y0, rows):
    """``warp_plain(..., y0)`` and ``warp`` on CPU tensors: output rows
    [y0, y0 + rows) from a flow of those rows equal the whole warp's."""
    rng = np.random.default_rng(C + y0)
    img = torch.from_numpy(rng.random((2, 37, 29, C), dtype=np.float32))
    flow = torch.from_numpy((6 * rng.standard_normal((2, 37, 29, 2))).astype(np.float32))
    full = warp_plain(img, flow, compat)
    part = flow[:, y0:y0 + rows].contiguous()
    assert torch.equal(warp_plain(img, part, compat, y0), full[:, y0:y0 + rows])
    assert torch.equal(warp(img, part, compat, y0), full[:, y0:y0 + rows])


def test_warp_rows_outside_the_reference_are_refused():
    img, flow = torch.zeros((1, 8, 4, 3)), torch.zeros((1, 3, 4, 2))
    with pytest.raises(ValueError, match="does not fit"):
        warp_plain(img, flow, "exact", 6)
    with pytest.raises(ValueError, match="does not fit"):
        warp(img, flow, "exact", -1)


def test_lhbdc_forward_matches_tpuvc_unsharded(lhbdc_ranks, tpuvc_lhbdc):
    n, ranks = lhbdc_ranks
    ref = tpuvc_lhbdc[3]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["x_hat"].numpy(), ref["x_hat"], atol=BAR, rtol=0)
        np.testing.assert_allclose(out["x_pred"].numpy(), ref["x_pred"], atol=BAR, rtol=0)
        np.testing.assert_allclose(out["sizes"].numpy(), ref["sizes"], rtol=BAR)
        np.testing.assert_allclose(float(out["bits"]), float(ref["bits"]), rtol=BAR)
        lo, hi = S.rows_of(256, n, r)
        assert out["rows"] == (1, hi - lo, 192, 3)
        # every rank holds the same totals
        assert float(out["bits"]) == float(ranks[0]["bits"])


def test_lhbdc_sharded_warps_read_other_ranks_rows(lhbdc_ranks):
    """SPyNet's and the compensation's warps sample rows of other ranks,
    and the convs' halos move bytes: the exchange is exercised."""
    n, ranks = lhbdc_ranks
    assert sum(out["stats"].samples_elsewhere for out in ranks) > 0
    for r, out in enumerate(ranks):
        st = out["stats"]
        assert st.bytes_fetched > 0
        # SPyNet's levels (256 -> 32 px: 4) and the two compensation warps
        assert len(st.warps) == 6
        assert {w[0] for w in st.warps} == {S.rows_of(w[2], n, r)[0] for w in st.warps}


def test_one_rank_spatial_forward_is_the_unsharded_forward(monkeypatch):
    """A mesh of one (no group): the sharded forward equals LHBDC.forward
    bit for bit, and modes other than 'dequantize' are refused."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    mesh = make_mesh(device="cpu")
    model = LHBDC(N=16, generator=torch.Generator().manual_seed(0)).eval()
    xb, xc, xa = (torch.from_numpy(x[:, :64, :128]) for x in spatial_frames())
    with torch.no_grad():
        ref = model(xb, xc, xa, "dequantize")
    out = S.spatial_forward(mesh, model, *S.shard_spatial(mesh, (xb, xc, xa)))
    assert torch.equal(out["x_hat"].x, ref["x_hat"])
    assert torch.equal(out["x_pred"].x, ref["x_pred"])
    assert torch.equal(out["sizes"], ref["sizes"])
    with pytest.raises(ValueError, match="dequantize"):
        S.spatial_forward(mesh, model, *S.shard_spatial(mesh, (xb, xc, xa)), mode="noise")


@pytest.mark.slow
def test_lhbdc_matches_tpuvcs_sharded_forward(lhbdc_ranks, tpuvc_lhbdc):
    """tpuvc's own H-sharded forward (shard_spatial on the virtual devices,
    XLA's halo exchanges) against the port's ranks, at tpuvc's bars."""
    n, ranks = lhbdc_ranks
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    jm, v = tpuvc_lhbdc[:2]
    mesh = jmesh.make_mesh(n)

    @jax.jit
    def fwd(b, c, a):
        out = jm.apply(v, b, c, a, "dequantize")
        return out["x_hat"], out["sizes"]

    with mesh:
        x_hat, sizes = fwd(*jmesh.shard_spatial(mesh, tuple(map(jnp.asarray, spatial_frames()))))
    for out in ranks:
        np.testing.assert_allclose(out["x_hat"].numpy(), np.asarray(x_hat), atol=BAR, rtol=0)
        np.testing.assert_allclose(out["sizes"].numpy(), np.asarray(sizes), rtol=BAR)
