"""Seeded parameter trees for tests that hold tpuvc_torch against tpuvc.

Initialising a large flax model runs every layer once, which costs minutes
on a small host. ``filled_params`` takes the tree's shapes from
``jax.eval_shape`` instead and fills every leaf from a numpy seed with
values of the right scale: conv kernels lecun-like, biases small and
nonzero, positive gains around 1, a factorized prior near its
initialisation. Both packages then run on the same values
(``params_from_jax`` carries them to the port), including heads that flax
would start at zero.
"""

import jax
import numpy as np


def _leaf(name: str, shape, rng):
    if name in ("kernel", "weight") or name.endswith("_kernel"):
        # HWIO kernels (DeformConv's is "weight", SPyNet's "conv{i}_kernel")
        return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    if name.startswith("matrix_"):
        return np.log(np.expm1(1.0 / 10 ** 0.2 / shape[1])) + 0.1 * rng.standard_normal(shape)
    if name.startswith("factor_"):
        return 0.1 * rng.standard_normal(shape)
    if name == "quantiles":
        return np.array([-10.0, 0.0, 10.0]) + 0.1 * rng.standard_normal(shape)
    if name == "beta":  # GDN, near its initialisation
        return 1.0 + 0.1 * np.abs(rng.standard_normal(shape))
    if name == "gamma":
        return np.sqrt(0.1 * np.eye(shape[0])) + 0.01 * np.abs(rng.standard_normal(shape))
    if name.endswith("Gain") or name in ("gain_matrix", "gain", "inv_gain"):
        # CondELIC's, Flex-Rate's, DMC's
        return np.exp(0.2 * rng.standard_normal(shape))
    if name.startswith("bias") or name.endswith("_bias"):
        return 0.02 * rng.standard_normal(shape)
    raise KeyError(f"no seeded fill for parameter {name}")


def filled_params(init_fn, seed: int = 0, scale: dict | None = None):
    """Seeded numpy values for the tree ``init_fn()`` would return.

    ``scale`` maps a '/'-joined path prefix to a factor for the kernels
    under it (the flow and offset heads are kept small, as trained heads
    are)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn)

    def fill(path, s):
        keys = [p.key for p in path]
        v = _leaf(keys[-1], s.shape, rng)
        joined = "/".join(keys)
        for prefix, f in (scale or {}).items():
            if joined.startswith(prefix) and keys[-1] in ("kernel", "weight"):
                v = v * f
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def write_sequence_checkpoints(wdir):
    """Seeded LHBDC (N=32, rate 845) and ELIC (N=16, M=24, groups
    (4, 4, 16)) checkpoints, written by tpuvc's save_checkpoint into
    ``wdir`` as the CLIs' ``--init load`` reads them:
    ``compression_845.msgpack`` and ``elic.msgpack``. Returns both trees."""
    import jax.numpy as jnp

    from tpuvc.models.elic import ELIC
    from tpuvc.models.lhbdc import LHBDC
    from tpuvc.utils.checkpoint import save_checkpoint

    x = jnp.zeros((1, 64, 64, 3))
    lhbdc = filled_params(lambda: LHBDC(N=32).init(jax.random.key(0), x, x, x, "dequantize"),
                          seed=4, scale={"flownet": 0.1})
    elic = filled_params(lambda: ELIC(N=16, M=24, groups=(4, 4, 16)).init(
        jax.random.key(0), x, "dequantize"), seed=5)
    save_checkpoint(str(wdir / "compression_845.msgpack"), lhbdc)
    save_checkpoint(str(wdir / "elic.msgpack"), elic)
    return lhbdc, elic


def dmc_params(seed: int = 6, flow: float | None = None, feat: int = 16, N: int = 32):
    """Seeded PFrameDMC parameters (tpuvc's test size by default). With
    ``flow``, SPyNet emits a near-constant horizontal flow of ``flow`` px
    on 128x128 inputs (three pyramid levels): each block's last conv
    kernel is scaled to 0.01 and its bias zeroed, the finest used block's
    (basic_2's) bias set to (flow, 0). At down ratio r the warp-only
    prediction then shifts the reference by about flow * 128 / w px (w the
    down-sampled width), so the ratio search's candidates differ clearly
    on a translating texture. Returns (flax module, variables)."""
    import jax.numpy as jnp

    from tpuvc.models.dmc import PFrameDMC

    model = PFrameDMC(feat=feat, N=N)
    x = jnp.zeros((1, 64, 64, 3))
    dpb = {"ref_frame": x, "ref_feature": None, "ref_down_ratio": 1.0}
    v = filled_params(lambda: model.init(jax.random.key(0), x, dpb, 1.0, "dequantize"),
                      seed=seed)
    if flow is not None:
        for i in range(6):
            block = v["params"]["optic_flow"][f"basic_{i}"]
            block["conv4_kernel"] = block["conv4_kernel"] * np.float32(0.01)
            block["conv4_bias"] = np.zeros(2, np.float32)
        v["params"]["optic_flow"]["basic_2"]["conv4_bias"] = np.array([flow, 0.0], np.float32)
    return model, v


def write_dmc_checkpoints(wdir, flow: float | None = None):
    """``dmc_params(flow=flow)`` and ELIC (N=16, M=24, groups (4, 4, 16))
    checkpoints, written by tpuvc's save_checkpoint into ``wdir`` as
    encode_p's ``--init load`` reads them: ``dmc.msgpack`` and
    ``elic.msgpack``. Returns both trees by name."""
    import jax.numpy as jnp

    from tpuvc.models.elic import ELIC
    from tpuvc.utils.checkpoint import save_checkpoint

    x = jnp.zeros((1, 64, 64, 3))
    _, dmc = dmc_params(flow=flow)
    elic = filled_params(lambda: ELIC(N=16, M=24, groups=(4, 4, 16)).init(
        jax.random.key(0), x, "dequantize"), seed=5)
    save_checkpoint(str(wdir / "dmc.msgpack"), dmc)
    save_checkpoint(str(wdir / "elic.msgpack"), elic)
    return {"dmc": dmc, "elic": elic}


#: FlowGuidedB at tests/test_flowguided.py's narrow widths.
V4_KW = dict(feature_channels=(16, 32, 48), N=32, M=32, levels=3, groups=(4, 4, 8, 16))


def v4_constant_flow_params(seed: int = 0, flow: float = 1.0):
    """Seeded narrow FlowGuidedB parameters whose FlowNET emits a nearly
    constant horizontal flow pair: its last subpel conv's kernel is scaled
    down to 0.02 and its bias set to (-flow, 0, +flow, 0) per flow channel
    (each repeated over the 2x2 sub-pixels), the offset heads seeded small.
    At down ratio r the flow-only prediction then shifts each reference by
    about 2 * flow * r px (times the temporal scale), so the down-ratio
    search's candidates differ clearly from each other. Returns (flax
    module, variables)."""
    import jax.numpy as jnp

    from tpuvc.models.flowguided_b import FlowGuidedB

    model = FlowGuidedB(**V4_KW)
    x = jnp.zeros((1, 64, 64, 3))
    v = filled_params(
        lambda: model.init(jax.random.key(0), x, x, x, 1, 0.5, -0.5, 1, "dequantize"),
        seed=seed,
        scale={"params/flow_estimator/SubpelConv_3": 0.02,
               **{f"params/offset_compressor/g_o{i}/Conv_1": 0.05 for i in (1, 2, 3)}},
    )
    head = v["params"]["flow_estimator"]["SubpelConv_3"]["Conv_0"]
    head["bias"] = np.repeat(np.array([-flow, 0.0, flow, 0.0], np.float32), 4)
    return model, v


def translating_frames(n: int, h: int, w: int, px_per_frame: int = 2, seed: int = 0):
    """n uint8 (h, w, 3) frames of one band-limited random texture moving
    right by ``px_per_frame`` a frame (crops of a wider canvas, no wrap)."""
    rng = np.random.default_rng(seed)
    width = w + px_per_frame * n
    f = np.fft.fft2(rng.standard_normal((h, width, 3)), axes=(0, 1))
    ky, kx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(width)[None]
    f *= np.exp(-(kx**2 + ky**2) * (2 * np.pi * 1.5) ** 2 / 2)[..., None]
    t = np.real(np.fft.ifft2(f, axes=(0, 1)))
    t = (t - t.min()) / (t.max() - t.min())
    x0 = px_per_frame * n
    return [
        np.rint(255 * t[:, x0 - px_per_frame * i : x0 - px_per_frame * i + w]).astype(np.uint8)
        for i in range(n)
    ]
