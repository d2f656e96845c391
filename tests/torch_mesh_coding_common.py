"""tpuvc's side of the port's mesh-coding tests: each family's small model
with seeded weights (``torch_params_common.filled_params``), tpuvc's mesh-2
coder on 2 of conftest's virtual CPU devices, and :func:`code_families`,
which runs the port's ranks (tests/torch_mesh_worker.py) and tpuvc on the
same weights and frames."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_mesh_worker import frames, run_ranks
from torch_params_common import V4_KW, filled_params
from tpuvc.parallel.mesh import level_batch_sharder, make_mesh
from tpuvc_torch.utils.convert import params_from_jax

FLEX_KW = dict(n_levels=4, N=32)
V3_KW = dict(feature_channels=(8, 16, 24), N=32, M=32, levels=3, groups=(4, 4, 8, 16))
HEADS = {
    "lhbdc": {},
    "flexrate": {"params/flow_compressor/g_s_layers_7": 0.1,
                 "params/residual_compressor/g_s_layers_7": 0.1},
    "flowguided_b": {"params/flow_estimator/SubpelConv_3": 1.0,
                     **{f"params/offset_compressor/g_o{i}/Conv_1": 0.05 for i in (1, 2, 3)}},
    "deform_b": {f"params/offset_compressor/g_o{i}/Conv_1": 1.0 for i in (1, 2, 3)},
}
HW = {"lhbdc": 64, "flexrate": 128, "flowguided_b": 64, "deform_b": 64}


def jax_family(fam):
    """(tpuvc model, its variables, the port model's kwargs)."""
    from tpuvc.models.deform_b import DeformB
    from tpuvc.models.flexrate import BidirFlowRef
    from tpuvc.models.flowguided_b import FlowGuidedB
    from tpuvc.models.lhbdc import LHBDC

    x = jnp.zeros((1, HW[fam], HW[fam], 3))
    if fam == "lhbdc":
        m, kw = LHBDC(N=16), dict(N=16)
        init = lambda: m.init(jax.random.key(0), x, x, x, "dequantize")  # noqa: E731
    elif fam == "flexrate":
        m, kw = BidirFlowRef(**FLEX_KW), FLEX_KW
        init = lambda: m.init(jax.random.key(0), x, x, x, 0, 1.0, "dequantize")  # noqa: E731
    elif fam == "flowguided_b":
        m, kw = FlowGuidedB(**V4_KW), V4_KW
        init = lambda: m.init(jax.random.key(0), x, x, x, 1, 0.5, -0.5, 1,  # noqa: E731
                              "dequantize")
    else:
        m, kw = DeformB(**V3_KW), V3_KW
        init = lambda: m.init(jax.random.key(0), x, x, x, 1, "dequantize")  # noqa: E731
    scale = {"flownet": 0.1} if fam == "lhbdc" else HEADS[fam]
    return m, filled_params(init, seed=3, scale=scale), kw


def jax_recon(fam, m, v, xs):
    """tpuvc's mesh-2 encoder's reconstruction of a level batch."""
    from tpuvc.models.deform_b import DeformBCoder
    from tpuvc.models.flexrate import FlexRateCoder
    from tpuvc.models.flowguided_b import FlowGuidedBCoder
    from tpuvc.models.lhbdc import LHBDCCoder

    coder = {"lhbdc": LHBDCCoder, "flexrate": FlexRateCoder, "flowguided_b": FlowGuidedBCoder,
             "deform_b": DeformBCoder}[fam](m, v)
    coder.set_shard(level_batch_sharder(make_mesh(2)))
    xb, xc, xa = (jnp.asarray(x.numpy()) for x in xs)
    if fam == "lhbdc":
        _, recon = coder.encode_level_batch(xb, xc, xa, rate_id=845)
    elif fam == "flexrate":
        _, recon = coder.encode_level_batch(xb, xc, xa, n=1, l=0.7)
    elif fam == "flowguided_b":
        _, recon = coder.encode_level_batch(xb, xa, xc, s=1.0, scale1=0.5, scale2=-0.5)
    else:
        _, recon = coder.encode_level_batch(xb, xa, xc, s=1.0)
    return np.asarray(recon)


def code_families(tmp, families) -> tuple:
    """(the ranks' outputs, tpuvc's mesh-2 reconstructions) by (family, B)
    for level batches of B=2 and B=3."""
    jax_models, models = {}, {}
    for fam in families:
        m, v, kw = jax_family(fam)
        jax_models[fam], models[fam] = (m, v), (kw, params_from_jax(v))
    xs = {fam: {b: frames(b, HW[fam], seed=10 + b) for b in (2, 3)} for fam in families}
    torch.save({"models": models, "frames": xs}, tmp / "inputs.pt")
    ranks = run_ranks("coding", tmp)
    refs = {(fam, b): jax_recon(fam, *jax_models[fam], xs[fam][b])
            for fam in families for b in (2, 3)}
    return ranks, refs
