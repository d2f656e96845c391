"""The port's mesh helpers (tpuvc_torch.parallel.mesh) in a 2-rank gloo group
on the CPU, held against tpuvc's (tpuvc.parallel.mesh) on 2 of conftest's 8
virtual CPU devices: the rows shard_batch gives each rank are the rows of
each device's shard, replicate leaves rank 0's values everywhere,
level_batch_sharder splits exactly the batches tpuvc's rule splits (and
replicates the rest), and shard_eval pads and drops as tpuvc's does
(tpuvc's tests/test_scheduler.py::test_pad_to_mesh_multiple). The ranks run
tests/torch_mesh_worker.py's ``helpers`` case once for the module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import run_ranks
from tpuvc.parallel import mesh as jmesh
from tpuvc_torch.parallel import mesh as tmesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("helpers", tmp_path_factory.mktemp("mesh"))


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    return jmesh.make_mesh(2)


def _shards(arr):
    """Each device's rows of a placed array, in device order."""
    return [np.asarray(s.data) for s in sorted(arr.addressable_shards,
                                                key=lambda s: s.device.id)]


def test_shard_batch_gives_each_rank_its_devices_rows(ranks, jax_mesh):
    x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    placed = jmesh.shard_batch(jax_mesh, {"x": jnp.asarray(x), "y": (jnp.asarray(x + 1),)})
    for r, out in enumerate(ranks):
        assert np.array_equal(out["shard_batch"]["x"].numpy(), _shards(placed["x"])[r])
        assert np.array_equal(out["shard_batch"]["y"][0].numpy(), _shards(placed["y"][0])[r])


def test_shard_batch_refuses_a_batch_the_mesh_does_not_divide(ranks, jax_mesh):
    with pytest.raises(ValueError):
        jmesh.shard_batch(jax_mesh, jnp.zeros((3, 2)))
    for out in ranks:
        assert "does not divide" in out["shard_batch_3"]


def test_replicate_leaves_rank_0s_values_on_every_rank(ranks, jax_mesh):
    placed = jmesh.replicate(jax_mesh, jnp.full((2, 3), 1.0))
    assert all(np.array_equal(s, np.full((2, 3), 1.0)) for s in _shards(placed))
    for out in ranks:
        assert torch.equal(out["replicate"]["w"], torch.full((2, 3), 1.0))
        assert torch.equal(out["replicate"]["opt"][0], torch.arange(4.0))


@pytest.mark.parametrize("b", range(1, 7))
def test_level_batch_sharder_splits_as_tpuvcs_rule(ranks, jax_mesh, b):
    """tpuvc splits a level batch its mesh divides and replicates the rest;
    each port rank codes the rows of its device's shard, and the gathers
    give every rank the whole level in row order."""
    placed = jmesh.level_batch_sharder(jax_mesh)(jnp.arange(float(b)))
    shards = _shards(placed)
    split = not all(len(s) == b for s in shards)
    assert split == (b % 2 == 0)
    for r, out in enumerate(ranks):
        assert np.array_equal(out["rows"][b].numpy(), shards[r])
        assert torch.equal(out["gathered"][b], torch.arange(float(b)))
        assert out["gather_list"][b] == [f"f{i}" for i in range(b)]


def test_shard_eval_pads_and_drops_as_tpuvc(ranks, jax_mesh):
    x = np.arange(3 * 4, dtype=np.float32).reshape(3, 4)
    f = jax.jit(lambda a: (a * 2.0, jnp.sum(a, axis=(1,))))
    with jax_mesh:
        y, s = jmesh.shard_eval(jax_mesh, f)(jnp.asarray(x))
    for out in ranks:
        ty, ts = out["shard_eval"]
        assert ty.shape == (3, 4) and ts.shape == (3,)
        assert np.array_equal(ty.numpy(), np.asarray(y))
        assert np.array_equal(ts.numpy(), np.asarray(s))
        # rows 0-1 were rank 0's, row 2 rank 1's (its padded row 3 dropped)
        assert out["shard_eval_rows"][:, 0].tolist() == [0.0, 0.0, 1.0]


def test_collectives_move_bfloat16_bits_and_average(ranks):
    want = torch.cat([(torch.arange(6.0).reshape(3, 2) / 7 + r).to(torch.bfloat16)
                      for r in range(2)])
    for out in ranks:
        assert out["bf16_gather"].dtype == torch.bfloat16
        assert torch.equal(out["bf16_gather"], want)
        assert torch.equal(out["mean"], torch.tensor([1.5, 4.5]))


def test_row_noise_gives_each_rank_its_rows_of_the_whole_draw(ranks):
    for out in ranks:
        got, want = out["noise_rows"]
        assert torch.equal(got, want)


def test_one_process_mesh_has_no_group_and_a_wrong_size_is_refused(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    m = tmesh.make_mesh(device="cpu")
    assert (m.size, m.rank, m.group, m.device.type) == (1, 0, None, "cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert tmesh.shard_batch(m, x) is not None and torch.equal(tmesh.shard_batch(m, x), x)
    with pytest.raises(ValueError, match="WORLD_SIZE=1"):
        tmesh.make_mesh(2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="WORLD_SIZE=3"):
        tmesh.make_mesh(2, device="cpu")


def test_mesh_entry_points_default_to_cuda_without_fallback(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()
    assert os.environ.get("WORLD_SIZE") is None
