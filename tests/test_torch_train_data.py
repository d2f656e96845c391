"""The training data, BD-rate and checkpoint modules of tpuvc_torch against
tpuvc's on the CPU: batches byte-equal to tpuvc's for a seed (3- and
5-frame windows, 0 and 4 decode workers), ``bd_rate`` equal to tpuvc's,
``save_checkpoint`` writing tpuvc's bytes (read back by tpuvc's
``load_checkpoint``), and ``params_to_jax`` the inverse of
``params_from_jax`` on every family's flax tree.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_params_common import V4_KW, filled_params

torch.set_num_threads(1)


@pytest.mark.parametrize("n_frames,workers,raw", [(3, 0, True), (3, 4, False), (5, 0, False),
                                                  (5, 4, True)])
def test_batches_equal_tpuvc(n_frames, workers, raw):
    from tpuvc.data.vimeo import SyntheticSeptuplets as JS
    from tpuvc.data.vimeo import make_batch_iterator as jit_
    from tpuvc_torch.data.vimeo import SyntheticSeptuplets, make_batch_iterator

    kw = dict(batch_size=3, crop=48, n_frames=n_frames, seed=7, workers=workers,
              prefetch=1 if workers else 0, raw_uint8=raw)
    ref = list(itertools.islice(jit_(JS(n=16, size=64, seed=2), **kw), 3))
    got = list(itertools.islice(make_batch_iterator(SyntheticSeptuplets(n=16, size=64, seed=2),
                                                    **kw), 3))
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype and g.shape == r.shape == (3, n_frames, 48, 48, 3)
        assert g.tobytes() == r.tobytes()


def test_vimeo_septuplets_read_the_list_and_pngs(tmp_path):
    from tpuvc.data.vimeo import VimeoSeptuplets as JV
    from tpuvc_torch.data.frames import save_png
    from tpuvc_torch.data.vimeo import VimeoSeptuplets

    rng = np.random.default_rng(0)
    for item in ("00001/0001", "00001/0002"):
        d = tmp_path / "sequences" / item
        d.mkdir(parents=True)
        for i in range(1, 8):
            save_png(d / f"im{i}.png", rng.integers(0, 256, (40, 56, 3), dtype=np.uint8))
    (tmp_path / "sep_trainlist.txt").write_text("00001/0001\n00001/0002\n\n")
    ds, jds = VimeoSeptuplets(str(tmp_path)), JV(str(tmp_path))
    assert len(ds) == len(jds) == 2
    for a, b in zip(ds.load(1, [2, 3, 4]), jds.load(1, [2, 3, 4])):
        np.testing.assert_array_equal(a, b)


def test_bd_rate_matches_tpuvc():
    from tpuvc.eval import bd_rate as jb
    from tpuvc_torch.eval import bd_rate as tb

    assert tb.ANCHORS == jb.ANCHORS
    ra, pa = jb.ANCHORS["icip2024_train"]
    rt = [r * 0.93 for r in ra]
    pt = [p - 0.05 for p in pa]
    for piecewise in (False, True):
        assert tb.bd_rate(ra, pa, rt, pt, piecewise) == jb.bd_rate(ra, pa, rt, pt, piecewise)
        assert tb.bd_psnr(ra, pa, rt, pt, piecewise) == jb.bd_psnr(ra, pa, rt, pt, piecewise)


def test_save_checkpoint_writes_tpuvc_bytes(tmp_path):
    from tpuvc.utils.checkpoint import load_checkpoint as jload
    from tpuvc.utils.checkpoint import save_checkpoint as jsave
    from tpuvc_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    rng = np.random.default_rng(3)
    tree = {"params": {"b": {"kernel": rng.random((3, 3, 4, 5), dtype=np.float32)},
                       "a" * 40: {"bias": np.zeros(300, np.float32)},
                       "c": {"idx": np.arange(70000, dtype=np.int32)}},
            "step": 123456}
    jsave(str(tmp_path / "j.msgpack"), tree)
    save_checkpoint(str(tmp_path / "t.msgpack"),
                    {**tree, "params": {**tree["params"],
                                        "b": {"kernel": torch.from_numpy(tree["params"]["b"]["kernel"])}}})
    assert (tmp_path / "t.msgpack").read_bytes() == (tmp_path / "j.msgpack").read_bytes()
    back = jload(str(tmp_path / "t.msgpack"))
    assert int(back["step"]) == 123456
    np.testing.assert_array_equal(back["params"]["b"]["kernel"], tree["params"]["b"]["kernel"])
    ours = load_checkpoint(str(tmp_path / "t.msgpack"))
    np.testing.assert_array_equal(ours["params"]["c"]["idx"], tree["params"]["c"]["idx"])
    assert not list(tmp_path.glob("*.tmp*"))


def _families():
    x = jnp.zeros((1, 64, 64, 3))
    key = jax.random.key(0)

    def lhbdc():
        from tpuvc.models.lhbdc import LHBDC as J
        from tpuvc_torch.models.lhbdc import LHBDC as T

        return (lambda: J(N=16).init(key, x, x, x, "dequantize")), T(N=16)

    def flowguided_b():
        from tpuvc.models.flowguided_b import FlowGuidedB as J
        from tpuvc_torch.models.flowguided_b import FlowGuidedB as T

        return (lambda: J(**V4_KW).init(key, x, x, x, 0, 0.5, -0.5, 1, "dequantize")), T(**V4_KW)

    def deform_b():
        from tpuvc.models.deform_b import DeformB as J
        from tpuvc_torch.models.deform_b import DeformB as T

        kw = dict(feature_channels=(8, 16, 24), N=32, M=32, levels=3, groups=(4, 4, 8, 16))
        return (lambda: J(**kw).init(key, x, x, x, 0, "dequantize")), T(**kw)

    def flexrate():
        from tpuvc.models.flexrate import BidirFlowRef as J
        from tpuvc_torch.models.flexrate import BidirFlowRef as T

        return (lambda: J(N=32).init(key, x, x, x, 0, 1.0, "dequantize")), T(N=32)

    def elic():
        from tpuvc.models.elic import ELIC as J
        from tpuvc_torch.models.elic import ELIC as T

        kw = dict(N=32, M=48, groups=(4, 4, 8, 32))
        return (lambda: J(**kw).init(key, x, "dequantize")), T(**kw)

    def dmc():
        from tpuvc.models.dmc import PFrameDMC as J
        from tpuvc_torch.models.dmc import PFrameDMC as T

        dpb = {"ref_frame": x, "ref_feature": None, "ref_down_ratio": 1.0}
        return (lambda: J().init(key, x, dpb, 1.0, "dequantize")), T()

    return {f.__name__: f for f in (lhbdc, flowguided_b, deform_b, flexrate, elic, dmc)}


@pytest.mark.parametrize("family", list(_families()))
def test_params_to_jax_inverts_params_from_jax(family):
    from tpuvc_torch.utils.convert import params_from_jax, params_to_jax

    init_fn, module = _families()[family]()
    tree = filled_params(init_fn)["params"]
    module.load_state_dict(params_from_jax(tree), strict=True)
    back = params_to_jax(module)
    ref = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert ref.keys() == got.keys()
    for k, v in ref.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v, err_msg=jax.tree_util.keystr(k))


def test_bd_checkpointer_saves_on_improvement_only():
    """BDCheckpointer keeps the checkpoint of the best BD-rate against its
    anchor, as tpuvc's does: the first finite curve saves, a worse one
    does not, a better one does."""
    from tpuvc.eval.bd_rate import ANCHORS
    from tpuvc.train.trainer import BDCheckpointer as JB
    from tpuvc_torch.train.trainer import BDCheckpointer

    ra, pa = ANCHORS["icip2024_train"]
    curves = [([r * 1.1 for r in ra], pa), ([r * 1.2 for r in ra], pa),
              ([r * 0.9 for r in ra], [p + 0.1 for p in pa])]
    saved, jsaved = [], []
    ours = BDCheckpointer(ra, pa, save_fn=saved.append)
    theirs = JB(ra, pa, save_fn=jsaved.append)
    for i, (rates, psnrs) in enumerate(curves):
        assert ours.update(rates, psnrs, i) == theirs.update(rates, psnrs, i)
    assert saved == jsaved == [0, 2] and ours.best_bd == theirs.best_bd < 0
