"""One rank of the port's multi-process CPU tests (imports torch and
tpuvc_torch only, no JAX).

    python tests/torch_mesh_worker.py CASE RANK WORLD DIR

joins a gloo group of WORLD processes through ``file://DIR/init_CASE`` (no
port), runs CASE on the CPU with one thread and saves what it computed to
``DIR/CASE_RANK.pt``; inputs come from numpy seeds, or from
``DIR/inputs.pt`` where the test wrote them. :func:`run_ranks` starts the
ranks and waits for them.

    python -m torch.distributed.run --standalone --nproc_per_node N \
        tests/torch_mesh_worker.py cli CLI DIR ARGS...

runs ``tpuvc_torch.cli.CLI.main(ARGS)`` in each rank of a torchrun launch
(the CLI joins the group itself) and saves its return value to
``DIR/CLI_RANK.pt``.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(case: str, tmp_dir, world: int = 2, timeout: int = 240) -> list:
    """Run CASE in ``world`` processes; returns each rank's saved dict.
    Fails naming the rank whose process failed."""
    import torch

    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                               str(world), str(tmp_dir)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {case} exited {p.returncode}:\n{out[-4000:]}")
    return [torch.load(os.path.join(tmp_dir, f"{case}_{r}.pt"), weights_only=False)
            for r in range(world)]


def frames(b: int, hw: int, seed: int):
    """(x_before, x_current, x_after) batches of b seeded hw x hw frames."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    base = rng.random((b, hw, hw, 3), dtype=np.float32)
    drift = 0.03 * rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    xb, xc, xa = base, np.clip(base + 0.5 * drift, 0, 1), np.clip(base + drift, 0, 1)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (xb, xc, xa))


def case_helpers(mesh, inputs):
    """shard_batch, replicate, the sharder's rows and gathers, shard_eval,
    the collectives on bfloat16 and the data-parallel noise rows."""
    import numpy as np
    import torch

    from tpuvc_torch.entropy.quant import RowNoise
    from tpuvc_torch.parallel.mesh import (
        all_gather_rows,
        all_reduce_mean,
        level_batch_sharder,
        replicate,
        shard_batch,
        shard_eval,
    )

    x = torch.from_numpy(np.arange(4 * 3, dtype=np.float32).reshape(4, 3))
    out = {"shard_batch": shard_batch(mesh, {"x": x, "y": (x + 1,)})}
    try:
        shard_batch(mesh, torch.zeros(3, 2))
        out["shard_batch_3"] = "accepted"
    except ValueError as e:
        out["shard_batch_3"] = str(e)
    # every rank starts from its own values; rank 0's win
    own = {"w": torch.full((2, 3), float(mesh.rank + 1)),
           "opt": [torch.arange(4.0) * (mesh.rank + 1)]}
    out["replicate"] = replicate(mesh, own)
    shard = level_batch_sharder(mesh)
    out["rows"] = {b: shard(torch.arange(float(b)))[:] for b in range(1, 7)}
    out["gathered"] = {b: shard.gather(shard(torch.arange(float(b))), b) for b in range(1, 7)}
    out["gather_list"] = {b: shard.gather_list(shard([f"f{i}" for i in range(b)]), b)
                          for b in range(1, 7)}
    xe = torch.from_numpy(np.arange(3 * 4, dtype=np.float32).reshape(3, 4))
    out["shard_eval"] = shard_eval(mesh, lambda a: (a * 2.0, torch.sum(a, dim=1)))(xe)
    out["shard_eval_rows"] = shard_eval(mesh, lambda a: a[:, :1] * 0 + mesh.rank)(xe)
    bf = (torch.arange(6.0).reshape(3, 2) / 7 + mesh.rank).to(torch.bfloat16)
    out["bf16_gather"] = all_gather_rows(mesh, bf)
    out["mean"] = all_reduce_mean(mesh, torch.tensor([1.0, 3.0]) * (mesh.rank + 1))
    full = torch.rand((4, 5, 2), generator=torch.Generator().manual_seed(9))
    noise = RowNoise(torch.Generator().manual_seed(9), 4, 2 * mesh.rank)
    out["noise_rows"] = (noise.rand((2, 5, 2), "cpu", torch.float32), full[2 * mesh.rank:][:2])
    return out


def case_coding(mesh, inputs):
    """Each family's level batch at B=2 (split) and B=3 (replicated):
    encode and decode over the mesh, and the streams' bytes."""
    import torch

    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import BFrameBitstream, VFrameBitstream
    from tpuvc_torch.parallel.mesh import level_batch_sharder

    coders = coders_from(inputs)
    out = {}
    for fam, coder in coders.items():
        coder.set_shard(level_batch_sharder(mesh))
        for b in (2, 3):
            xb, xc, xa = inputs["frames"][fam][b]
            if fam == "lhbdc":
                bits, recon = coder.encode_level_batch(xb, xc, xa, rate_id=845)
                parse = BFrameBitstream
            elif fam == "flexrate":
                bits, recon = coder.encode_level_batch(xb, xc, xa, n=1, l=0.7)
                parse = BFrameBitstream
            elif fam == "flowguided_b":
                bits, recon = coder.encode_level_batch(xb, xa, xc, s=1.0, scale1=0.5,
                                                       scale2=-0.5)
                parse = VFrameBitstream
            else:
                bits, recon = coder.encode_level_batch(xb, xa, xc, s=1.0)
                parse = VFrameBitstream
            blobs = [x.serialize() for x in bits]
            dec = coder.decode_level_batch(xb, xa, [parse.deserialize(x) for x in blobs])
            out[(fam, b)] = {"recon": recon, "dec": dec, "blobs": blobs}
    parallel.shutdown()
    return out


def coders_from(inputs) -> dict:
    """The port's coders on the CPU from the state dicts the test wrote."""
    from tpuvc_torch.models.deform_b import DeformB, DeformBCoder
    from tpuvc_torch.models.flexrate import BidirFlowRef, FlexRateCoder
    from tpuvc_torch.models.flowguided_b import FlowGuidedB, FlowGuidedBCoder
    from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder

    build = {"lhbdc": (LHBDC, LHBDCCoder), "flexrate": (BidirFlowRef, FlexRateCoder),
             "flowguided_b": (FlowGuidedB, FlowGuidedBCoder),
             "deform_b": (DeformB, DeformBCoder)}
    out = {}
    for fam, (kw, state) in inputs["models"].items():
        model_cls, coder_cls = build[fam]
        model = model_cls(**kw)
        model.load_state_dict(state, strict=True)
        out[fam] = coder_cls(model, device="cpu")
    return out


def train_step_setup(seed: int = 0):
    """LHBDC(N=16) seeded, its optimizer, a step in 'noise' mode and a
    (4, 3, 64, 64, 3) batch: the 2-rank test's global step."""
    import numpy as np
    import torch

    from tpuvc_torch.models.lhbdc import LHBDC
    from tpuvc_torch.train.trainer import make_lhbdc_step, make_optimizer

    model = LHBDC(N=16, generator=torch.Generator().manual_seed(seed))
    tx = GradRecorder(make_optimizer())
    step = make_lhbdc_step(model, tx, alpha=1626.0)
    rng = np.random.default_rng(seed + 1)
    base = rng.random((4, 1, 64, 64, 3), dtype=np.float32)
    drift = 0.05 * rng.standard_normal((4, 1, 64, 64, 3)).astype(np.float32)
    batch = torch.from_numpy(np.clip(np.concatenate([base - drift, base, base + drift], 1), 0, 1))
    return model, tx, step, batch


class GradRecorder:
    """An optimizer that keeps the gradients each update was given."""

    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params=None, value=None):
        self.grads.append({n: g.detach().clone() for n, g in grads.items()})
        self.value = float(value)
        return self.tx.update(grads, state, params, value=value)


def case_train(mesh, inputs):
    """One data-parallel LHBDC step on this rank's rows of the global
    batch: the averaged gradients the optimizer got, the loss it saw, and
    the parameters after the step; the seeds make every rank's model and
    batch alike, and rank 1 starts from perturbed weights so replicate must
    restore rank 0's."""
    import torch

    from tpuvc_torch.cli.train import params_sha256
    from tpuvc_torch.parallel.mesh import replicate, shard_batch
    from tpuvc_torch.train.trainer import data_parallel

    model, tx, step, batch = train_step_setup()
    params = dict(model.named_parameters())
    if mesh.rank:
        with torch.no_grad():
            for p in params.values():
                p.add_(1e-3)
    params = replicate(mesh, params)
    opt = replicate(mesh, tx.init(params))
    with data_parallel(mesh, batch.shape[0]):
        params, opt, metrics = step(params, opt, shard_batch(mesh, batch), (1, 0))
    return {"grads": tx.grads[0], "loss": tx.value, "metrics": metrics,
            "params": {n: p.detach().clone() for n, p in params.items()},
            "sha256": params_sha256(params)}


def case_coding_card(mesh, inputs):
    """LHBDC(N=32) and FlowGuidedB (narrow, heads seeded) level batches of
    128x128 frames on the card at B=2 (split) and B=3 (whole on each rank):
    the warp and deform kernels run at each rank's rows."""
    import torch

    import chip_smoke
    from tpuvc_torch.coder import parallel
    from tpuvc_torch.coder.container import BFrameBitstream, VFrameBitstream
    from tpuvc_torch.models.flowguided_b import FlowGuidedB, FlowGuidedBCoder
    from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder
    from tpuvc_torch.parallel.mesh import level_batch_sharder

    v4 = FlowGuidedB(feature_channels=(16, 32, 48), N=32, M=32, levels=3, groups=(4, 4, 8, 16),
                     generator=torch.Generator().manual_seed(0))
    chip_smoke.seed_zero_heads(v4, torch.Generator().manual_seed(1))
    coders = {"lhbdc": LHBDCCoder(LHBDC(N=32, generator=torch.Generator().manual_seed(0))),
              "flowguided_b": FlowGuidedBCoder(v4)}
    out = {}
    for fam, coder in coders.items():
        coder.set_shard(level_batch_sharder(mesh))
        for b in (2, 3):
            xb, xc, xa = frames(b, 128, seed=20 + b)
            chip_smoke.reset_launches()
            if fam == "lhbdc":
                bits, recon = coder.encode_level_batch(xb, xc, xa, rate_id=845)
                parse = BFrameBitstream
            else:
                bits, recon = coder.encode_level_batch(xb, xa, xc, s=1.0, scale1=0.5,
                                                       scale2=-0.5)
                parse = VFrameBitstream
            blobs = [x.serialize() for x in bits]
            dec = coder.decode_level_batch(xb, xa, [parse.deserialize(x) for x in blobs])
            out[(fam, b)] = {"recon": recon.cpu(), "dec": dec.cpu(), "blobs": blobs,
                             "launches": chip_smoke.read_launches()}
    parallel.shutdown()
    return out


CASES = {"helpers": case_helpers, "coding": case_coding, "train": case_train,
         "coding_card": case_coding_card}


def main(case: str, rank: int, world: int, tmp_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_dir}/init_{case}", rank=rank,
                            world_size=world)
    from tpuvc_torch.parallel.mesh import make_mesh

    try:
        mesh = make_mesh(world, device="cuda" if case.endswith("_card") else "cpu")
        path = os.path.join(tmp_dir, "inputs.pt")
        inputs = torch.load(path, weights_only=False) if os.path.exists(path) else None
        out = CASES[case](mesh, inputs)
        torch.save(out, os.path.join(tmp_dir, f"{case}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_cli(cli: str, out_dir: str, argv: list) -> None:
    import importlib

    import torch

    torch.set_num_threads(1)
    out = importlib.import_module(f"tpuvc_torch.cli.{cli}").main(argv)
    torch.save(out, os.path.join(out_dir, f"{cli}_{os.environ['RANK']}.pt"))


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        run_cli(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
