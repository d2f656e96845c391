"""``python -m tpuvc_torch.cli.train`` (its ``main``) for every family on
the CPU at small widths: 2 steps on synthetic data, a checkpoint in tpuvc's
layout, then a resume from step 2 to step 3. The recursive families train
both stages (``stage2_start=1``) and run the BD-rate validation."""

import math

import numpy as np
import pytest
import torch

from tpuvc_torch.cli import train
from tpuvc_torch.utils.checkpoint import load_checkpoint
from tpuvc_torch.utils.convert import params_from_jax, params_to_jax

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "batch_size=1", "crop=64", "workers=0", "prefetch=0",
         "stage2_start=1", "val_every=100", "dataset_root=/nonexistent"]
FAMILIES = {
    "lhbdc": ["model.N=16"],
    "elic": ["model.N=32", "model.M=320"],
    "flowguided_b": ["model.N=32", "model.levels=2", "model.feature_channels=(16,32,48)"],
    "deform_b": ["model.N=32", "model.levels=2"],
    "flexrate": ["model.N=32", "model.levels=2"],
    "dmc": ["n_pframes=2"],
}


def _initial(family, overrides):
    """The family's seeded initial weights, as the CLI builds them."""
    from tpuvc_torch.config import TrainConfig, apply_overrides
    from tpuvc_torch.train.trainer import make_optimizer

    cfg = apply_overrides(TrainConfig(), [f"model.family={family}", *overrides])
    model, _, _ = train.build_family(cfg, make_optimizer(), np.random.default_rng(0))
    return params_to_jax(model), model


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_cli_two_steps_then_resume(family, tmp_path):
    extra = FAMILIES[family]
    args = SMALL + [f"model.family={family}", f"checkpoint_dir={tmp_path}", *extra]
    first = train.main(args + ["total_steps=2"])
    assert first["steps"] == 2 and first["start_step"] == 0
    assert all(math.isfinite(v) for v in first["metrics"].values()), first
    assert {"loss", "rate", "mse", "aux"} <= set(first["metrics"])
    # plain versions on the CPU
    assert first["launches"] == {"warp": 0, "deform": 0, "epilogue": 0}

    ck = load_checkpoint(str(tmp_path / "latest.msgpack"))
    assert int(ck["step"]) == 2
    init, model = _initial(family, extra)
    model.load_state_dict(params_from_jax(ck["params"]), strict=True)
    moved = {"main": False, "quantiles": False}
    flat_init = dict(_flat(init))
    for path, v in _flat(ck["params"]):
        if not np.array_equal(v, flat_init[path]):
            moved["quantiles" if path[-1] == "quantiles" else "main"] = True
    assert moved == {"main": True, "quantiles": True}
    assert first["validations"] == (1 if family in ("flowguided_b", "deform_b", "flexrate")
                                    else 0)
    assert (tmp_path / "best.msgpack").exists() == (first["best_bd_rate"] is not None
                                                     and math.isfinite(first["best_bd_rate"]))

    second = train.main(args + ["total_steps=3"])
    assert second["start_step"] == 2 and second["steps"] == 1
    assert int(load_checkpoint(str(tmp_path / "latest.msgpack"))["step"]) == 3
    assert "resumed from" in (tmp_path / "train.log").read_text()


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def test_lhbdc_checkpoint_loads_in_tpuvc(tmp_path):
    """The port writes tpuvc's tree: tpuvc's LHBDC applies it unchanged."""
    import jax
    import jax.numpy as jnp

    from tpuvc.models.lhbdc import LHBDC
    from tpuvc.utils.checkpoint import load_checkpoint as jload

    train.main(SMALL + ["model.family=lhbdc", "model.N=16", f"checkpoint_dir={tmp_path}",
                        "total_steps=1"])
    params = jload(str(tmp_path / "latest.msgpack"))["params"]
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: LHBDC(N=16).init(jax.random.key(0), x, x, x, "dequantize"))
    ref = jax.tree_util.tree_structure(shapes["params"])
    assert jax.tree_util.tree_structure(params) == ref
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(params),
                                                   jax.tree.leaves(shapes["params"])))


def test_unknown_family_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown family"):
        train.main(SMALL + ["model.family=nope", "total_steps=1", f"checkpoint_dir={tmp_path}"])


def test_default_device_is_cuda_without_fallback(tmp_path):
    """Without --device the CLI trains on cuda, and without a card it raises
    rather than training on the CPU."""
    args = ["model.family=lhbdc", "model.N=16", "total_steps=1", f"checkpoint_dir={tmp_path}"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(args)
