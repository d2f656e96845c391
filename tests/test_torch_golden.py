"""Golden records of the port's own CPU streams: each family's stream must
be byte-identical (sha256, length) to tests/golden/torch_golden.json and
its reconstruction's PSNR within 1e-3 dB. A deliberate change of the
port's stream bytes regenerates the file with scripts/gen_golden_torch.py
and commits the diff."""

import json
import os

import pytest
import torch

from torch_golden_common import CASES, record

torch.set_num_threads(1)

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_golden.json")


@pytest.fixture(scope="module")
def golden():
    with open(_GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("family", sorted(CASES))
def test_torch_golden(family, golden):
    expected = golden[family]
    got = record(family)
    assert got["stream_len"] == expected["stream_len"], (got, expected)
    assert got["stream_sha256"] == expected["stream_sha256"], (
        f"{family}: the port's stream bytes drifted (len {got['stream_len']} vs "
        f"{expected['stream_len']}); if the change is deliberate, rerun "
        "scripts/gen_golden_torch.py"
    )
    assert got["psnr"] == pytest.approx(expected["psnr"], abs=1e-3)


def test_golden_covers_every_family(golden):
    assert sorted(k for k in golden if not k.startswith("_")) == sorted(CASES) == [
        "deform_b", "dmc", "elic", "flexrate", "flowguided_b", "lhbdc"]
