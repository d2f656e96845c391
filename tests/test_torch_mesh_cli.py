"""The port's multi-device CLIs on the CPU, as tpuvc's tests/test_vseq_cli.py
runs tpuvc's (test_level_batched_mesh_round_trip,
test_level_batched_mesh_v34_round_trip): ``encode_v --mesh 2`` and
``decode_v`` each under ``python -m torch.distributed.run --standalone
--nproc_per_node 2`` with gloo ranks (``--device cpu``), LHBDC (N=32) and
ELIC (N=16, M=24) on 9 synthetic 64x64 frames at GOP 4, level-batched at
batch cap 2 (level batches of 2, which the mesh splits, and of 1, which
every rank codes whole). The header records mesh=2 in tpuvc's bytes, rank 0
alone writes and prints, and every rank's decode equals the encoder's
reconstructions bit for bit. Then the refusals: ``--mesh`` without
``--level_batched``, a mesh other than the launch's WORLD_SIZE, and
``decode_v`` of a mesh-2 stream under another world size. Last, the eval
CLI runs a ``device_count=2`` config on one device, as tpuvc's does, with
the rows of ``device_count=1``.
"""

import os
import subprocess
import sys

import pytest
import torch

from torch_mesh_worker import ROOT
from tpuvc.coder import container as jcont
from tpuvc_torch.coder import container as tcont

torch.set_num_threads(1)

WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
SMALL = [
    "--synthetic", "9", "--width", "64", "--height", "64", "--gop", "4",
    "--init", "random", "--N", "32",
    "--intra_N", "16", "--intra_M", "24", "--intra_groups", "4,4,16",
    "--device", "cpu",
]
MODEL_ARGS = SMALL[SMALL.index("--init"):]
LEVEL_BATCHED = ["--family", "lhbdc", "--level_batched", "--max_batch", "2", "--l", "845"]


def _torchrun(tmp_path, cli, argv, n=2):
    """Run ``cli`` in ``n`` torchrun ranks; -> (each rank's return value,
    the launch's output)."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(n), "--", WORKER, "cli", cli, str(tmp_path), *argv],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    outs = [torch.load(tmp_path / f"{cli}_{r}.pt", weights_only=False) for r in range(n)]
    return outs, proc.stdout


@pytest.fixture(scope="module")
def mesh2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    bin_path = str(tmp / "seq.tpvb")
    enc, enc_log = _torchrun(tmp, "encode_v", SMALL + LEVEL_BATCHED
                             + ["--mesh", "2", "--bin", bin_path])
    dec, dec_log = _torchrun(tmp, "decode_v", MODEL_ARGS + [
        "--bin", bin_path, "--out_dir", str(tmp / "dec"), "--synthetic", "9"])
    with open(bin_path, "rb") as f:
        blob = f.read()
    return enc, enc_log, dec, dec_log, blob, tmp


def test_encode_v_mesh2_records_the_mesh_in_tpuvcs_bytes(mesh2):
    _, enc_log, _, _, blob, _ = mesh2
    port, ref = tcont.VSequenceBitstream.deserialize(blob), jcont.VSequenceBitstream.deserialize(blob)
    assert port.mesh == ref.mesh == 2 and port.mode == ref.mode == 1
    assert ref == jcont.VSequenceBitstream(**vars(port))
    assert sorted(i for _, i, _ in ref.frames) == list(range(9))
    # rank 0 alone prints (and writes the file)
    assert enc_log.count("wrote ") == 1 and "mesh 2" in enc_log


def test_decode_v_replays_the_mesh_bit_exact(mesh2):
    enc, _, dec, dec_log, _, tmp = mesh2
    for rank in range(2):
        assert sorted(enc[rank]) == sorted(dec[rank]) == list(range(9))
        for i in range(9):
            assert enc[rank][i].shape == (64, 64, 3)
            assert torch.equal(dec[rank][i], enc[0][i]), (rank, i)
            assert torch.equal(enc[rank][i], enc[0][i]), (rank, i)
    assert sorted(os.listdir(tmp / "dec")) == [f"frame_{i:05d}.png" for i in range(9)]
    assert dec_log.count("decoded 9 frames") == 1


def test_mesh_needs_the_level_batched_mode(tmp_path):
    from tpuvc_torch.cli import encode_v

    with pytest.raises(SystemExit, match="--mesh requires --level_batched"):
        encode_v.main(SMALL + ["--mesh", "2", "--bin", str(tmp_path / "x.tpvb")])


@pytest.mark.parametrize("mesh", ["2", "3"])
def test_mesh_other_than_the_world_size_is_refused(tmp_path, monkeypatch, mesh):
    from tpuvc_torch.cli import encode_v

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match=f"mesh has {mesh} device.*WORLD_SIZE=1"):
        encode_v.main(SMALL + LEVEL_BATCHED + ["--mesh", mesh,
                                               "--bin", str(tmp_path / "x.tpvb")])
    with pytest.raises(SystemExit, match="out of range"):
        encode_v.main(SMALL + LEVEL_BATCHED + ["--mesh", "256",
                                               "--bin", str(tmp_path / "x.tpvb")])


def test_decode_v_refuses_another_world_size(mesh2, monkeypatch):
    from tpuvc_torch.cli import decode_v

    *_, tmp = mesh2
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="mesh has 2 device.*WORLD_SIZE=1"):
        decode_v.main(MODEL_ARGS + ["--bin", str(tmp / "seq.tpvb"),
                                    "--out_dir", str(tmp / "dec1")])


def test_eval_cli_runs_a_device_count_2_config_on_one_device(tmp_path):
    """tpuvc declares device_count and reads it nowhere: its eval runs such a
    config on one device. So does the port's, with the same rows."""
    from tpuvc_torch.cli import test as ttest

    args = ["--device", "cpu", "dataset.name=synthetic", 'dataset.sequences={"synth": 5}',
            "dataset.gop=4", "dataset.width=64", "dataset.height=64", "model.family=lhbdc",
            "model.N=16", "levels=(0,)"]
    rows = {}
    for n in (1, 2):
        out = ttest.main(args + [f"output_dir={tmp_path / str(n)}", f"device_count={n}"])
        rows[n] = out["results"]
    assert rows[1] and rows[2] == rows[1]
