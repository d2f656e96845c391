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
    return start_ranks(case, tmp_dir, world)(timeout)


def start_ranks(case: str, tmp_dir, world: int = 2):
    """Start CASE in ``world`` processes; returns ``wait(timeout)``, which
    waits for them and returns each rank's saved dict, failing as
    :func:`run_ranks` does."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                               str(world), str(tmp_dir)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def wait(timeout: int = 240) -> list:
        import torch

        outs = [p.communicate(timeout=timeout)[0] for p in procs]
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of {case} exited {p.returncode}:\n{out[-4000:]}")
        return [torch.load(os.path.join(tmp_dir, f"{case}_{r}.pt"), weights_only=False)
                for r in range(world)]

    return wait


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


def spatial_op_cases():
    """{name: (input (B, H, W, C), sharded op (sp, rows) -> rows, plain op (x) -> x)}:
    each sharded op of tpuvc_torch.parallel.spatial and its unsharded
    counterpart. The heights make shards of 1 row, uneven shards, an empty
    shard (5 rows over 4 ranks), halos wider than a shard, a reflected pad
    that reaches past the neighbouring rank, shards that start at odd rows
    (18 rows: 0, 5, 10, 15 over 4 ranks, 0, 9 over 2) and deform offsets
    that reach past the neighbouring rank and out of the frame."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tpuvc_torch.models import layers as L
    from tpuvc_torch.models.unet import _maxpool2, _up2
    from tpuvc_torch.ops import checkerboard, pad, resample
    from tpuvc_torch.ops.deform import DeformConv
    from tpuvc_torch.parallel.spatial import take_rows

    def conv(k, stride, cin, cout, seed):
        g = torch.Generator().manual_seed(seed)
        c = L.Conv(cin, cout, kernel=k, stride=stride)
        with torch.no_grad():
            c.weight.copy_(torch.randn(c.weight.shape, generator=g) / (k * (cin ** 0.5)))
            c.bias.copy_(0.1 * torch.randn(c.bias.shape, generator=g))
        return (lambda sp, x: sp.conv(x, c)), c

    cases = {}
    for name, (k, s, H, cin, cout) in {
        "conv3x3_s1": (3, 1, 16, 8, 8),
        "conv3x3_s2_rows_of_1": (3, 2, 4, 16, 16),  # XLA's shard < stride case
        "conv3x3_s2_h8": (3, 2, 8, 16, 16),
        "conv5x5_s1_empty_shard": (5, 1, 5, 6, 4),
        "conv7x7_halo_past_neighbour": (7, 1, 8, 8, 2),
        "conv1x1_s2": (1, 2, 10, 4, 4),
        "conv3x3_s2_odd": (3, 2, 17, 4, 4),
    }.items():
        sharded, c = conv(k, s, cin, cout, seed=H + k)
        cases[name] = ((1, H, 6, cin), sharded, c)
    cases["pixel_shuffle_empty_shard"] = (
        (1, 5, 3, 8), lambda sp, x: sp.pixel_shuffle(x, 2),
        lambda x: resample.pixel_shuffle(x, 2))
    sub = L.init_weights(L.SubpelConv(3, 4, r=2), torch.Generator().manual_seed(3))
    cases["subpel_conv"] = ((2, 5, 4, 3), lambda sp, x: sp.pixel_shuffle(
        sp.conv(x, sub.Conv_0), 2), sub)
    cases["avg_pool2"] = ((2, 8, 6, 3), lambda sp, x: sp.pool(x, 2),
                          lambda x: resample.avg_pool2d(x, 2))
    cases["avg_pool4"] = ((1, 16, 8, 2), lambda sp, x: sp.pool(x, 4),
                          lambda x: resample.avg_pool2d(x, 4))
    cases["max_pool2"] = ((1, 10, 6, 3), lambda sp, x: sp.max_pool2(x), _maxpool2)
    cases["up2"] = ((1, 5, 7, 3), lambda sp, x: sp.up2(x), _up2)
    cases["upsample2x_flow"] = ((2, 9, 5, 2), lambda sp, x: sp.upsample2x_flow(x),
                                resample.upsample2x_flow)
    cases["upsample_flow_x4"] = ((1, 17, 6, 2), lambda sp, x: sp.upsample_flow(x, 4),
                                 lambda x: resample.upsample_flow(x, 4))
    # DMC's antialiased downsample by 1.5: 17 rows to 11 (3, 3, 3, 2 over 4
    # ranks), each output row reading about 3 input rows; and by 4
    for (H, W), (h, w) in (((17, 9), (11, 6)), ((16, 8), (4, 8))):
        cases[f"resize_antialias_{H}_to_{h}"] = (
            (1, H, W, 3), lambda sp, x, h=h, w=w: sp.resize_antialias(x, h, w),
            lambda x, h=h, w=w: resample.resize_antialias(x, h, w))
    cases["pad_reflect_wraps"] = ((1, 17, 5, 2), lambda sp, x: sp.pad_to_multiple(x, 64)[0],
                                  lambda x: pad.pad_to_multiple(x, 64)[0])
    cases["pad_reflect_past_neighbour"] = (
        (1, 68, 4, 2), lambda sp, x: sp.pad_to_multiple(x, 64)[0],
        lambda x: pad.pad_to_multiple(x, 64)[0])
    cases["unpad"] = ((1, 64, 6, 2), lambda sp, x: sp.unpad(x, (17, 5)),
                      lambda x: pad.unpad(x, (17, 5)))
    cases["relu_map"] = ((1, 7, 3, 2), lambda sp, x: x.map(F.relu), F.relu)
    for k, H in ((3, 5), (3, 8), (5, 5), (5, 9)):
        d = L.init_weights(L.Deconv(4, 3, kernel=k), torch.Generator().manual_seed(k + H))
        with torch.no_grad():
            d.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(H))
        cases[f"deconv{k}_h{H}"] = ((1, H, 4, 4), lambda sp, x, d=d: sp.deconv(x, d), d)
    cb = L.init_weights(checkerboard.CheckerboardConv(4, 6), torch.Generator().manual_seed(5))
    cases["conv_checkerboard5x5_odd_starts"] = ((1, 18, 5, 4), lambda sp, x: sp.conv(x, cb), cb)
    for name in ("keep_anchor", "keep_non_anchor"):
        cases[f"checkerboard_{name}_odd_starts"] = (
            (2, 18, 5, 3), lambda sp, x, name=name: getattr(sp, name)(x),
            getattr(checkerboard, name))
    cases["pad_constant_x16"] = ((1, 17, 5, 2), lambda sp, x: sp.pad_to_multiple(
        x, 16, mode="constant")[0], lambda x: pad.pad_to_multiple(x, 16, mode="constant")[0])
    # 16 rows (4 a rank over 4): offsets of up to +-10 rows reach two ranks
    # away and out of the frame
    rng = np.random.default_rng(11)
    for G, Cg, Og in ((2, 3, 2), (4, 4, 4)):
        conv = L.init_weights(DeformConv(G * Cg, G * Og, groups=G),
                              torch.Generator().manual_seed(G))
        with torch.no_grad():
            conv.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(G))
        off = torch.from_numpy((4 * rng.standard_normal((2, 16, 7, G * 18))).astype(np.float32))
        off[..., 0::2] *= 2.5
        msk = torch.from_numpy(rng.random((2, 16, 7, G * 9), dtype=np.float32))

        def sharded(sp, x, conv=conv, off=off, msk=msk):
            return sp.deform(x, take_rows(sp.mesh, off), take_rows(sp.mesh, msk), conv)

        cases[f"deform_g{G}_reach_past_neighbour_and_frame"] = (
            (2, 16, 7, G * Cg), sharded, lambda x, conv=conv, off=off, msk=msk: conv(x, off, msk))
    return cases


def case_spatial_ops(mesh, inputs):
    """Each of spatial_op_cases on seeded inputs: the sharded op's output
    gathered on every rank and the unsharded op's; fetch_rows of an
    arbitrary list; the warp of this rank's rows and the whole frame's
    rows; the bits over the ranks and in one process; shard_spatial's rows
    and its refusal of an H the mesh does not divide."""
    import numpy as np
    import torch

    from tpuvc_torch.entropy.emath import likelihood_to_bits, per_sample_bits
    from tpuvc_torch.ops.warp import warp_plain
    from tpuvc_torch.parallel import spatial as S

    stats = S.SpatialStats()
    sp = S.Spatial(mesh, stats)
    rng = np.random.default_rng(7)
    out = {"ops": {}}
    with torch.no_grad():
        for name, (shape, sharded, plain) in spatial_op_cases().items():
            x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            y = sharded(sp, S.take_rows(mesh, x))
            out["ops"][name] = (S.gather_rows(mesh, y), plain(x),
                                tuple(y.x.shape), S.rows_of(y.H, mesh.size, mesh.rank))
        x = torch.from_numpy(rng.standard_normal((2, 11, 3, 4)).astype(np.float32))
        need = {r: rng.integers(0, 11, size=5 + r) for r in range(mesh.size)}
        out["fetch"] = (S.fetch_rows(mesh, S.take_rows(mesh, x), lambda r: need[r]),
                        x[:, need[mesh.rank]])
        out["warp"] = {}
        for compat in ("exact", "lhbdc", "flexrate"):
            for C in (3, 48):
                img = torch.from_numpy(rng.random((1, 13, 9, C), dtype=np.float32))
                flow = torch.from_numpy((5 * rng.standard_normal((1, 13, 9, 2))).astype(np.float32))
                y = sp.warp(S.take_rows(mesh, img), S.take_rows(mesh, flow), compat)
                out["warp"][(compat, C)] = (y.x, S.rows_of(13, mesh.size, mesh.rank),
                                            warp_plain(img, flow, compat))
        liks = [torch.from_numpy(rng.uniform(1e-3, 1, (2, h, 3, 4)).astype(np.float32))
                for h in (5, 8)]
        totals, per_sample = sp.bits([S.take_rows(mesh, p).x for p in liks])
        out["bits"] = (torch.stack(totals), torch.stack(per_sample),
                       torch.stack([likelihood_to_bits(p) for p in liks]),
                       torch.stack([per_sample_bits(p) for p in liks]))
    x = torch.from_numpy(np.arange(2 * 8 * 3 * 1, dtype=np.float32).reshape(2, 8, 3, 1))
    out["shard_spatial"] = S.shard_spatial(mesh, {"x": x, "y": (x + 1,)})
    try:
        S.shard_spatial(mesh, torch.zeros((1, 4 * mesh.size + 1, 3, 3)))
        out["shard_spatial_odd"] = "accepted"
    except ValueError as e:
        out["shard_spatial_odd"] = str(e)
    out["stats"] = stats
    return out


def spatial_frames(h: int = 256, w: int = 192, seed: int = 0):
    """tpuvc's TestSpatialSharding frames: (x_before, x_current, x_after) =
    (base, base + 0.02, base + 0.01), clipped, as (1, h, w, 3)."""
    import numpy as np

    base = np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)
    x1, x2 = base, np.clip(base + 0.01, 0, 1)
    x3 = np.clip(base + 0.02, 0, 1)
    return tuple(np.ascontiguousarray(x[None]) for x in (x1, x3, x2))


def case_spatial_lhbdc(mesh, inputs):
    """LHBDC(N=16) from the state dict the test wrote, H-sharded over the
    mesh in 'dequantize' mode: x_hat and x_pred gathered, the bits, the
    sizes, the stats."""
    import torch

    from tpuvc_torch.models.lhbdc import LHBDC
    from tpuvc_torch.parallel import spatial as S

    model = LHBDC(N=16)
    model.load_state_dict(inputs["state"], strict=True)
    model.eval()
    frames = [torch.from_numpy(x) for x in spatial_frames()]
    stats = S.SpatialStats()
    out = S.spatial_forward(mesh, model, *S.shard_spatial(mesh, frames), stats=stats)
    return {"x_hat": S.gather_rows(mesh, out["x_hat"]), "x_pred": S.gather_rows(mesh, out["x_pred"]),
            "rows": tuple(out["x_hat"].x.shape), "stats": stats,
            **{k: out[k] for k in ("bits", "bits_flow", "bits_residual", "sizes", "rate")}}


def spatial_card_model():
    """LHBDC(N=32), seeded: the card test's model."""
    import torch

    from tpuvc_torch.models.lhbdc import LHBDC

    return LHBDC(N=32, generator=torch.Generator().manual_seed(0))


def case_spatial_card(mesh, inputs):
    """spatial_card_model H-sharded over the mesh on the card: x_hat
    gathered, the sizes, the warp launches and the warps' rows."""
    import torch

    from tpuvc_torch.ops import warp
    from tpuvc_torch.ops.precision import set_deterministic
    from tpuvc_torch.parallel import spatial as S

    set_deterministic()
    model = spatial_card_model().to(mesh.device).eval()
    frames = [torch.from_numpy(x).to(mesh.device) for x in spatial_frames()]
    stats = S.SpatialStats()
    warp.warp_kernel.launches = 0
    out = S.spatial_forward(mesh, model, *S.shard_spatial(mesh, frames), stats=stats)
    return {"x_hat": S.gather_rows(mesh, out["x_hat"]).cpu(), "sizes": out["sizes"].cpu(),
            "launches": warp.warp_kernel.launches, "warps": stats.warps}


#: The v3/v4 spatial forwards' frame and runs: (family, spatial_forward's
#: family_args). 192 rows: the /16 latents' 12 rows start at 0, 3, 6 and 9
#: over 4 ranks, so the checkerboard parity of odd starts is exercised.
V34_FRAME = (192, 128)
V34_RUNS = (("flowguided_b", {"s": 1.0, "down_ratio": 1}),
            ("flowguided_b", {"s": 1.0, "down_ratio": 4}),
            ("deform_b", {"s": 1.0}))


def v34_model(family: str, state=None):
    """The narrow v4 (torch_params_common.V4_KW) or v3 (tests/
    test_torch_deform_b.py's widths) model, with ``state`` loaded."""
    from tpuvc_torch.models.deform_b import DeformB
    from tpuvc_torch.models.flowguided_b import FlowGuidedB

    if family == "flowguided_b":
        model = FlowGuidedB(feature_channels=(16, 32, 48), N=32, M=32, levels=3,
                            groups=(4, 4, 8, 16))
    else:
        model = DeformB(feature_channels=(8, 16, 24), N=32, M=32, levels=3, groups=(4, 4, 8, 16))
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model.eval()


def case_spatial_v34(mesh, inputs):
    """Each of V34_RUNS on the state dicts the test wrote, H-sharded over
    the mesh: x_hat gathered, the bits, sizes, the stats."""
    import torch

    from tpuvc_torch.parallel import spatial as S

    frames = [torch.from_numpy(x) for x in spatial_frames(*V34_FRAME)]
    out = {}
    for family, kw in V34_RUNS:
        model = v34_model(family, inputs["state"][family])
        stats = S.SpatialStats()
        got = S.spatial_forward(mesh, model, *S.shard_spatial(mesh, frames), stats=stats, **kw)
        out[(family, kw.get("down_ratio"))] = {
            "x_hat": S.gather_rows(mesh, got["x_hat"]), "rows": tuple(got["x_hat"].x.shape),
            "stats": stats, **{k: got[k] for k in ("bits", "size", "sizes", "rate")}}
    return out


def spatial_card_v4_model():
    """Narrow FlowGuidedB (torch_params_common.V4_KW's widths), seeded, its
    flow and offset heads seeded: the card test's v4 model."""
    import torch

    import chip_smoke

    return chip_smoke.v4_model(torch, N=32, feature_channels=(16, 32, 48), levels=3,
                               groups=(4, 4, 8, 16))


def case_spatial_v4_card(mesh, inputs):
    """spatial_card_v4_model H-sharded over the mesh on the card at 128x128:
    x_hat gathered, the sizes, both kernels' launches, the warps' and
    deform convs' rows."""
    import torch

    import chip_smoke
    from tpuvc_torch.ops.precision import set_deterministic
    from tpuvc_torch.parallel import spatial as S

    set_deterministic()
    model = spatial_card_v4_model().to(mesh.device).eval()
    frames = [torch.from_numpy(x).to(mesh.device) for x in spatial_frames(128, 128)]
    stats = S.SpatialStats()
    chip_smoke.reset_launches()
    out = S.spatial_forward(mesh, model, *S.shard_spatial(mesh, frames), stats=stats, s=1.0)
    return {"x_hat": S.gather_rows(mesh, out["x_hat"]).cpu(), "sizes": out["sizes"].cpu(),
            "launches": chip_smoke.read_launches(), "warps": stats.warps,
            "deforms": stats.deforms}


#: The Flex-Rate, DMC and ELIC spatial forwards' frames (H, W) and model
#: widths. 192 rows: Flex-Rate's and ELIC's /16 rows start at 0, 3, 6, 9
#: over 4 ranks, their /64 rows are 1, 1, 1, 0; 160 rows: DMC's /8 latents'
#: rows start at 0, 5, 10, 15 and its /32 hyper latents' rows are 2, 2, 1, 0.
REST_FRAMES = {"flexrate": (192, 128), "dmc": (160, 192), "elic": (192, 128)}
REST_KW = {"flexrate": dict(N=32), "dmc": dict(feat=16, N=32),
           "elic": dict(N=16, M=24, groups=(4, 4, 16))}
REST_RATE = (1, 0.66)  # Flex-Rate's level n and interpolation l
#: DMC's chain: (ratio, q) of each P-frame, the first from frame 0 with an
#: empty DPB, each later one from the sharded DPB before it. At 1.5 the 160
#: rows go to 104, edge-padded to 128.
REST_DMC_CHAIN = ((1.0, 0.0), (1.5, 1.3))


def rest_frames(family: str):
    """The family's seeded frames at REST_FRAMES: the B-frame triple
    (spatial_frames) for Flex-Rate, its x_current for ELIC, and for DMC
    frames 0, 1, 2 of a texture drifting by noise (frame 0 the first
    reference)."""
    import numpy as np

    h, w = REST_FRAMES[family]
    if family == "flexrate":
        return spatial_frames(h, w)
    if family == "elic":
        return spatial_frames(h, w)[1:2]
    rng = np.random.default_rng(3)
    base = rng.random((1, h, w, 3), dtype=np.float32)
    drift = 0.03 * rng.standard_normal((3, h, w, 3)).astype(np.float32)
    xs = np.clip(base + np.cumsum(drift, axis=0), 0, 1)
    return tuple(np.ascontiguousarray(x[None]) for x in xs)


def rest_model(family: str, state=None, seed: int | None = None):
    """The narrow BidirFlowRef, PFrameDMC or ELIC of REST_KW, with
    ``state`` loaded; or with the models' own seeded initialisers
    (``seed``; Flex-Rate's flow-refinement head seeded as chip_smoke.py
    seeds it), for the card, where tpuvc is not installed."""
    import torch

    from tpuvc_torch.models.dmc import PFrameDMC
    from tpuvc_torch.models.elic import ELIC
    from tpuvc_torch.models.flexrate import BidirFlowRef

    cls = {"flexrate": BidirFlowRef, "dmc": PFrameDMC, "elic": ELIC}[family]
    if seed is None:
        model = cls(**REST_KW[family])
        model.load_state_dict(state, strict=True)
    else:
        import chip_smoke

        model = cls(generator=torch.Generator().manual_seed(seed), **REST_KW[family])
        if family == "flexrate":
            chip_smoke.seed_zero_heads(model, torch.Generator().manual_seed(seed + 1))
    return model.eval()


def spatial_rest(mesh, models: dict) -> dict:
    """Flex-Rate, DMC's chain and ELIC (``models`` by family), H-sharded
    over the mesh: per run, x_hat gathered, the bits, sizes, rows, the
    stats and the warp kernel's launches; DMC's DPBs gathered too (each
    next frame's reference starts from them)."""
    import torch

    from tpuvc_torch.ops import warp
    from tpuvc_torch.parallel import spatial as S

    def run(model, *args, **kw):
        stats = S.SpatialStats()
        before = warp.warp_kernel.launches
        got = S.spatial_forward(mesh, model, *args, stats=stats, **kw)
        return got, {"x_hat": S.gather_rows(mesh, got["x_hat"]).cpu(),
                     "rows": tuple(got["x_hat"].x.shape), "stats": stats,
                     "launches": warp.warp_kernel.launches - before,
                     **{k: got[k].cpu() for k in ("bits", "sizes")}}

    out = {}
    for family, model in models.items():
        rows = S.shard_spatial(mesh, [torch.from_numpy(x).to(mesh.device)
                                      for x in rest_frames(family)])
        if family != "dmc":
            kw = dict(zip(("n", "l"), REST_RATE)) if family == "flexrate" else {}
            out[(family, 0)] = run(model, *rows, **kw)[1]
            continue
        dpb = {"ref_frame": rows[0]}
        for i, (ratio, q) in enumerate(REST_DMC_CHAIN):
            got, out[(family, i)] = run(model, rows[i + 1], dpb, ratio=ratio, q=q)
            dpb = got["dpb"]
            out[(family, i)]["dpb"] = {
                k: v if k == "ref_down_ratio" else S.gather_rows(mesh, v).cpu()
                for k, v in dpb.items()}
    return out


def case_spatial_rest(mesh, inputs):
    """spatial_rest on the state dicts the test wrote."""
    return spatial_rest(mesh, {f: rest_model(f, inputs["state"][f]) for f in REST_FRAMES})


def case_spatial_rest_card(mesh, inputs):
    """spatial_rest on the card, the models seeded (rest_model's ``seed``
    0)."""
    from tpuvc_torch.ops.precision import set_deterministic

    set_deterministic()
    return spatial_rest(mesh, {f: rest_model(f, seed=0).to(mesh.device) for f in REST_FRAMES})


CASES = {"helpers": case_helpers, "coding": case_coding, "train": case_train,
         "coding_card": case_coding_card, "spatial_ops": case_spatial_ops,
         "spatial_lhbdc": case_spatial_lhbdc, "spatial_card": case_spatial_card,
         "spatial_v34": case_spatial_v34, "spatial_v4_card": case_spatial_v4_card,
         "spatial_rest": case_spatial_rest, "spatial_rest_card": case_spatial_rest_card}


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
