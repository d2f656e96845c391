"""Mesh-sharded level-batched coding of the CondELIC families (FlowGuidedB and
DeformB at tpuvc's small test widths, their offset heads seeded) over 2
gloo ranks on the CPU, held against tpuvc's mesh-2 coders (tests/
test_v4_bitstream.py and test_deform_b.py's mesh tests): as
test_torch_mesh_coding.py does for LHBDC and Flex-Rate, at B=2 (split) and
B=3 (replicated), bit-exact at mesh 2 and within 2e-5 of tpuvc.
"""

import jax
import numpy as np
import pytest
import torch

from torch_mesh_coding_common import HW, code_families

torch.set_num_threads(1)

FAMILIES = ["flowguided_b", "deform_b"]


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


