"""Mesh-sharded level-batched coding and data-parallel training in the port,
over 2 gloo ranks on the CPU, held against tpuvc's mesh-2 coders on 2 of
conftest's 8 virtual CPU devices (the counterparts of tpuvc's
tests/test_bitstream.py::TestMeshShardedCoding, test_v4_bitstream.py and
test_deform_b.py's mesh tests).

LHBDC (N=16) and Flex-Rate (N=32, 4 gain levels) here, FlowGuidedB and
DeformB in test_torch_mesh_coding_v34.py (weights seeded by
``torch_params_common.filled_params`` and carried by ``params_from_jax``;
tests/torch_mesh_coding_common.py). Each family codes a level batch of 64x64 frames (Flex-Rate 128x128: its hyperprior codes
at /64) at B=2, which the mesh splits, and B=3, which every rank codes
whole. Every rank's decode over the mesh equals the encoder's
reconstructions bit for bit, the ranks agree, and the reconstructions lie
within 2e-5 of tpuvc's mesh-2 encoder's. Then one data-parallel LHBDC step
('noise' quantization, each rank on its rows of a global batch of 4) against
the same step in one process: the gradients the optimizer gets within 1e-5
of each tensor's max, the same loss, and the ranks' parameters identical
after the step.
"""

import jax
import numpy as np
import pytest
import torch

from torch_mesh_coding_common import HW, code_families
from torch_mesh_worker import run_ranks, train_step_setup

torch.set_num_threads(1)

FAMILIES = ["lhbdc", "flexrate"]


@pytest.fixture(scope="module")
def coded(tmp_path_factory):
    """(the ranks' outputs, tpuvc's reconstructions by (family, B))."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    return code_families(tmp_path_factory.mktemp("coding"), FAMILIES)


@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("fam", FAMILIES)
def test_mesh2_level_batch_decodes_bit_exact(coded, fam, b):
    ranks, _ = coded
    r0 = ranks[0][(fam, b)]
    assert r0["recon"].shape == (b, HW[fam], HW[fam], 3)
    assert len(r0["blobs"]) == b
    for out in ranks:
        got = out[(fam, b)]
        assert torch.equal(got["dec"], got["recon"])
        # every rank ends the level with the same frames and streams
        assert torch.equal(got["recon"], r0["recon"])
        assert got["blobs"] == r0["blobs"]


@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("fam", FAMILIES)
def test_mesh2_level_batch_matches_tpuvc_mesh2(coded, fam, b):
    ranks, refs = coded
    got = ranks[0][(fam, b)]["recon"].numpy()
    np.testing.assert_allclose(got, refs[(fam, b)], atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ranks = run_ranks("train", tmp_path_factory.mktemp("train"))
    model, tx, step, batch = train_step_setup()
    params = dict(model.named_parameters())
    params, _, metrics = step(params, tx.init(params), batch, (1, 0))
    return ranks, tx.grads[0], tx.value, params


def test_data_parallel_step_matches_the_one_process_step(trained):
    ranks, grads, loss, _ = trained
    for out in ranks:
        assert out["loss"] == pytest.approx(loss, rel=1e-6)
        assert sorted(out["grads"]) == sorted(grads)
        for n, g in grads.items():
            scale = max(float(g.abs().max()), 1e-30)
            err = float((out["grads"][n] - g).abs().max()) / scale
            assert err <= 1e-5, (n, err)


def test_data_parallel_step_leaves_the_ranks_identical(trained):
    ranks, _, _, params = trained
    assert ranks[0]["sha256"] == ranks[1]["sha256"]
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n
    # and moved them as the one-process step did, within a tenth of the
    # learning rate (Adam's first update is lr * g / (|g| + eps): a gradient
    # near eps moves it by float noise)
    worst = max(float((ranks[0]["params"][n] - p.detach()).abs().max()) for n, p in params.items())
    assert worst <= 1e-5
