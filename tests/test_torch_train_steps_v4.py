"""FlowGuidedB's (v4) training loss and gradients,
tpuvc_torch against tpuvc, through each package's ``make_recursive_step``
in 'ste' (stage 1; both stages are held on Flex-Rate in
tests/test_torch_train_steps.py), both packages in float64: the loss within
1e-5 relative, every gradient tensor within 2e-3 of its max |g|. A file of
its own so that the test runner's workers take it beside the other step
tests.
"""

import jax
import jax.numpy as jnp
import torch

from torch_params_common import V4_KW, filled_params
from torch_train_common import batch_np, recursive_parity
from tpuvc_torch.utils.convert import params_from_jax

torch.set_num_threads(1)


def test_flowguided_b_recursive_gradients_match_tpuvc():
    from tpuvc.models.flowguided_b import FlowGuidedB as J
    from tpuvc_torch.models.flowguided_b import FlowGuidedB as T

    jm = J(**V4_KW)
    x = jnp.zeros((1, 64, 64, 3))
    v = filled_params(lambda: jm.init(jax.random.key(0), x, x, x, 1, 0.5, -0.5, 1, "dequantize"),
                      seed=3, scale={f"params/offset_compressor/g_o{i}/Conv_1": 0.05
                                     for i in (1, 2, 3)})["params"]
    tm = T(**V4_KW)
    tm.load_state_dict(params_from_jax(v))
    recursive_parity("flowguided_b", jm, v, tm, batch_np((1, 5, 64, 64, 3), seed=1),
               stage2=False, level=1, dr=2)
