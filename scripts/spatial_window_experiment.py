"""Which window strategy makes the H-sharded FlowGuidedB and DeformB
forwards (tpuvc_torch.parallel.spatial) agree with the unsharded forward on
the card: per codec, the flips of round(y - mean) and round(y) against the
unsharded forward in this process, and x_hat's largest difference, for

  current                   Spatial as it is;
  whole_le_H8               levels of at most H/8 rows computed whole on
                            every rank (each keeps its rows);
  deconv_whole              transposed convs computed whole on every rank;
  whole_le_H8_deconv_whole  both;
  deconv_align8, _align16   transposed-conv windows starting at a multiple
                            of 8 (16) input rows.

    PYTHONPATH=.:scripts python3 scripts/spatial_window_experiment.py main

(``SPATIAL_EXPERIMENT_DEVICE=cpu SPATIAL_EXPERIMENT_FRAME=128x192``
rehearse it on the CPU.) Four ranks share the card over gloo, one launch a
configuration. It was run on this PR's intermediate tree, where
``Spatial.deconv`` cut a window for each rank's rows: there ``current`` is
all windows; on a tree whose ``Spatial.deconv`` computes the whole
transposed conv, ``current`` equals ``deconv_whole``.
"""
import os, subprocess, sys, tempfile
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from tpuvc_torch.parallel import spatial as S

DEV = os.environ.get("SPATIAL_EXPERIMENT_DEVICE", "cuda")
FRAME = tuple(int(v) for v in os.environ.get("SPATIAL_EXPERIMENT_FRAME", "1088x1920").split("x"))
FAMS = ("deform_b", "flowguided_b")
CONFIGS = {"current": {}, "whole_le_H8": {"whole": 8}, "deconv_whole": {"deconv": "whole"},
           "whole_le_H8_deconv_whole": {"whole": 8, "deconv": "whole"},
           "deconv_align8": {"deconv": 8}, "deconv_align16": {"deconv": 16}}


def patch(cfg, H):
    whole_below = H // cfg["whole"] if "whole" in cfg else 0
    orig = S.Spatial._windowed

    def _windowed(self, x, H_out, span, op):
        if H_out <= whole_below:
            full = self.fetch(x, lambda r: np.arange(x.H))
            a, b = self.rows(H_out)
            return S.Rows(op(full, 0, H_out)[:, a:b], H_out)
        return orig(self, x, H_out, span, op)

    S.Spatial._windowed = _windowed
    mode = cfg.get("deconv")
    if mode == "whole":
        def deconv(self, x, d):
            full = self.fetch(x, lambda r: np.arange(x.H))
            a, b = self.rows(x.H * d.stride)
            return S.Rows(d(full)[:, a:b], x.H * d.stride)
        S.Spatial.deconv = deconv
    elif isinstance(mode, int):
        import torch.nn.functional as F

        def deconv(self, x, d, A=mode):
            k, s = d.kernel, d.stride
            p = k // 2
            H, W = x.H, x.x.shape[2]

            def first(a):
                return (max(0, -(-(a + p - k + 1) // s)) // A) * A

            def op(win, a, b):
                if a >= b:
                    return win.new_zeros((win.shape[0], 0, W * s, d.weight.shape[1]))
                if (a, b) == (0, H * s):
                    return d(win)
                i0 = first(a)
                y = F.conv_transpose2d(win.permute(0, 3, 1, 2), d.weight, d.bias, stride=s,
                                       padding=(0, p), output_padding=(0, s - 1))
                return y.permute(0, 2, 3, 1)[:, a - i0 * s + p:b - i0 * s + p]

            def span(a, b):
                return S._span(a, b, first(a), (b - 1 + p) // s + 1, H)

            return self._windowed(x, H * s, span, op)
        S.Spatial.deconv = deconv


def capture(model):
    got = {}
    for short, codec in (("off", "offset_compressor"), ("res", "residual_compressor")):
        inner = getattr(model, codec).gaussian

        class K:
            def __call__(self, *a, short=short, inner=inner, **k):
                got.setdefault(f"{short}_y", []).append(a[0].detach())
                got.setdefault(f"{short}_mu", []).append(k["means"].detach())
                return inner(*a, **k)

            def __getattr__(self, n, inner=inner):
                return getattr(inner, n)

        getattr(model, codec).gaussian = K()
    return got


def rank_main(out_dir, name):
    import torch.distributed as dist
    from tpuvc_torch.ops.precision import set_deterministic
    from tpuvc_torch.parallel.mesh import make_mesh

    patch(CONFIGS[name], FRAME[0])
    mesh = make_mesh(backend="gloo", device=DEV)
    if DEV == "cuda":
        set_deterministic()
    for fam in FAMS:
        model, frames = cs.spatial_inputs(torch, mesh.device, FRAME, fam)
        got = capture(model)
        out = S.spatial_forward(mesh, model, *S.shard_spatial(mesh, frames),
                                **cs.SPATIAL_FAMILIES[fam])
        torch.save({"x_hat": out["x_hat"].x.cpu(), "bits": float(out["bits"]),
                    **{k: torch.cat(v, -1).cpu() for k, v in got.items()}},
                   os.path.join(out_dir, f"{name}_{fam}_{mesh.rank}.pt"))
        del model, frames, out
        if DEV == "cuda":
            cs.release_cache(torch)
        dist.barrier()
    dist.destroy_process_group()


def main():
    from tpuvc_torch.ops.precision import set_deterministic
    if DEV == "cuda":
        set_deterministic()
        cs.build_kernels()
    ref = {}
    for fam in FAMS:
        model, frames = cs.spatial_inputs(torch, DEV, FRAME, fam)
        got = capture(model)
        with torch.no_grad():
            o = cs.unsharded_forward(model, fam, frames)
        ref[fam] = {"x_hat": o["x_hat"].cpu(), "bits": float(o["bits"]),
                    **{k: torch.cat(v, -1).cpu() for k, v in got.items()}}
        del model, frames, o
        if DEV == "cuda":
            cs.release_cache(torch)
    tmp = tempfile.mkdtemp()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.getcwd() + ":" + here)
    for name in CONFIGS:
        subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "4", os.path.abspath(__file__), "rank", tmp, name],
                       check=True, env=env, timeout=600, stdout=subprocess.DEVNULL)
        for fam in FAMS:
            rs = [torch.load(os.path.join(tmp, f"{name}_{fam}_{r}.pt")) for r in range(4)]
            row = {"config": name, "family": fam,
                   "x_hat_max_abs_diff": float((torch.cat([r["x_hat"] for r in rs], 1)
                                                - ref[fam]["x_hat"]).abs().max()),
                   "bits_rel": abs(rs[0]["bits"] - ref[fam]["bits"]) / ref[fam]["bits"]}
            for short in ("off", "res"):
                y = torch.cat([r[f"{short}_y"] for r in rs], 1)
                mu = torch.cat([r[f"{short}_mu"] for r in rs], 1)
                y0, mu0 = ref[fam][f"{short}_y"], ref[fam][f"{short}_mu"]
                lik = torch.round(y - mu) != torch.round(y0 - mu0)
                rnd = torch.round(y) != torch.round(y0)
                row[short] = {"flips": int((lik | rnd).sum()), "lik": int(lik.sum()),
                              "round": int(rnd.sum()), "dy_max": float((y - y0).abs().max()),
                              "dmu_median": float((mu - mu0).abs().median())}
            cs.emit(row)


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        rank_main(sys.argv[2], sys.argv[3])
    else:
        main()
