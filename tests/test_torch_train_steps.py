"""Each family's training loss and its gradients, tpuvc_torch against tpuvc,
on the same parameters (``filled_params``) and numpy batches, in the
deterministic quantization mode ('ste'), through each package's own step
code: ``make_recursive_step`` (Flex-Rate through both stages: the chain
that feeds the middle reconstruction into the quarter frames; FlowGuidedB
and DeformB in tests/test_torch_train_steps_v4.py and _v3.py), ``make_dmc_step`` (the
cascaded chain of two P-frames) and the ELIC intra loss (``stage2``, the
CLI's ``i_stage2``); and remat against no remat in 'noise'.

Both packages run in float64 (``jax.enable_x64``; the port's modules and
inputs in double): the loss within 1e-5 relative, every gradient tensor
within 2e-3 of its max |g|. In float32 a sample point that sits within
rounding of a pixel boundary flips its bilinear cell in one package and not
in the other; that alone moves SPyNet's block gradients by up to 3.7e-3 of
their max, in either package against its own float64 result (LHBDC,
tests/test_torch_train_repairs.py). float64 removes those flips, so the bar
holds the semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import dmc_params, filled_params
from torch_train_common import GRAB, batch_np, float64_parity, port_grads, recursive_parity
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

BETA = 0.0207  # an ICIP beta


def test_flexrate_recursive_gradients_match_tpuvc():
    from tpuvc.models.flexrate import BidirFlowRef as J
    from tpuvc_torch.models.flexrate import BidirFlowRef as T

    kw = dict(n_levels=4, N=32)
    jm = J(**kw)
    x = jnp.zeros((1, 64, 64, 3))
    v = filled_params(lambda: jm.init(jax.random.key(0), x, x, x, 0, 1.0, "dequantize"),
                      seed=5)["params"]
    tm = T(**kw)
    tm.load_state_dict(params_from_jax(v))
    recursive_parity("flexrate", jm, v, tm, batch_np((1, 5, 64, 64, 3), seed=3),
               stage2=True, level=3, dr=1)


def test_dmc_cascaded_gradients_match_tpuvc():
    from tpuvc.train.trainer import make_dmc_step as jstep
    from tpuvc_torch.models.dmc import PFrameDMC
    from tpuvc_torch.train.trainer import make_dmc_step, make_optimizer

    jm, v = dmc_params(seed=7)
    v = v["params"]
    tm = PFrameDMC(feat=16, N=32)
    tm.load_state_dict(params_from_jax(v))
    q = 1.5
    jdmc = jstep(jm, GRAB, beta=BETA, n_pframes=2, remat=False, warp_weight=0.1)

    def jfn(p, b):
        _, grads, met = jdmc(p, GRAB.init(p), b, jax.random.key(0), q)
        return met["loss"], grads

    tdmc = make_dmc_step(tm, make_optimizer(), beta=BETA, n_pframes=2, remat=True,
                         warp_weight=0.1)
    float64_parity(jfn, v, tm, lambda b: tdmc.loss_fn(b, 0, q)[0], batch_np((1, 3, 64, 64, 3), seed=4))


def test_elic_stage2_gradients_match_tpuvc():
    """The CLI's ELIC loss (tpuvc's is inline in its cli/train.py, copied
    here): lam * 255^2 * MSE + bpp + aux, bits from likelihoods floored at
    1e-9, 'ste', stage2."""
    from tpuvc.models.elic import ELIC as J
    from tpuvc_torch.cli.train import make_elic_step
    from tpuvc_torch.models.elic import ELIC as T
    from tpuvc_torch.train.trainer import make_optimizer

    kw = dict(N=32, M=48, groups=(4, 4, 8, 32))
    lam = 0.0207
    jm = J(**kw)
    x = jnp.zeros((1, 64, 64, 3))
    v = filled_params(lambda: jm.init(jax.random.key(0), x, "dequantize"), seed=6)["params"]
    tm = T(**kw)
    tm.load_state_dict(params_from_jax(v))

    @jax.jit
    def jfn(p, b):
        def loss_fn(p):
            x = b[:, 0]
            out = jm.apply({"params": p}, x, "ste", stage2=True)
            bits = sum(-jnp.sum(jnp.log2(jnp.maximum(lk, 1e-9)))
                       for lk in out["likelihoods"].values())
            n_pix = x.shape[0] * x.shape[1] * x.shape[2]
            mse = jnp.mean((out["x_hat"] - x) ** 2)
            aux = jm.apply({"params": p}, method=J.aux_loss)
            return lam * 255**2 * mse + bits / n_pix + aux

        return jax.value_and_grad(loss_fn)(p)

    step = make_elic_step(tm, make_optimizer(), lam, stage2=True, mode="ste")
    float64_parity(jfn, v, tm, lambda b: step.loss_fn(b, 0)[0], batch_np((2, 3, 64, 64, 3), seed=5))


@pytest.mark.parametrize("fam", ["deform_b", "flexrate"])
def test_remat_gives_the_gradients_of_the_plain_step(fam):
    """'noise' mode through torch.utils.checkpoint: each coded frame draws
    its noise from a generator seeded inside the checkpointed call, so the
    recomputed forward draws the same noise and the gradients equal those
    of the step without remat."""
    from tpuvc_torch.cli.train import code_fn_for
    from tpuvc_torch.models.deform_b import DeformB
    from tpuvc_torch.models.flexrate import BidirFlowRef
    from tpuvc_torch.train.trainer import make_optimizer, make_recursive_step

    g = torch.Generator().manual_seed(0)
    model = (DeformB(feature_channels=(8, 16, 24), N=32, M=32, levels=3,
                     groups=(4, 4, 8, 16), generator=g) if fam == "deform_b"
             else BidirFlowRef(n_levels=4, N=32, generator=g))
    batch = torch.from_numpy(batch_np((1, 5, 64, 64, 3), seed=7))
    grads = []
    for remat in (True, False):
        step = make_recursive_step(code_fn_for(fam, model), model.aux_loss, make_optimizer(),
                                   beta=BETA, remat=remat)
        loss, _ = step.loss_fn(batch, (1, 5), True, 1, 1)
        grads.append(port_grads(loss, model))
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
