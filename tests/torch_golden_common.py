"""Fixed-seed golden records of the port's own CPU streams.

One place defines each family's small seeded model, its fixed inputs and
the record (the stream's sha256 and length, the reconstruction's PSNR);
``scripts/gen_golden_torch.py`` writes them to
``tests/golden/torch_golden.json`` and ``tests/test_torch_golden.py``
holds every run to them, so a change of the port's stream bytes is a
visible, recorded choice. The models are the port's alone (torch.Generator
seeds, the zero-initialised flow and offset heads seeded as
``chip_smoke.seed_zero_heads`` does, so warps and deform taps are
fractional), at 64x64-class shapes, on one CPU thread. Nothing here
imports JAX: these are not tpuvc's goldens (tests/golden/golden.json), whose
streams the port does not reproduce byte for byte.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _frames(shape=(1, 64, 64, 3), drift_scale=0.04, seed=7):
    import torch

    rng = np.random.default_rng(seed)
    base = rng.random(shape, dtype=np.float32)
    drift = drift_scale * rng.standard_normal(shape).astype(np.float32)
    x1 = base
    xc = np.clip(base + 0.5 * drift, 0, 1)
    x2 = np.clip(base + drift, 0, 1)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (x1, xc, x2))


def _psnr(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def _record(blob: bytes, x_hat, x_ref) -> dict:
    return {
        "stream_sha256": hashlib.sha256(blob).hexdigest(),
        "stream_len": len(blob),
        "psnr": round(_psnr(x_hat, x_ref), 4),
    }


def _seeded(cls, seed: int, heads: bool = True, **kw):
    import torch

    from chip_smoke import seed_zero_heads

    model = cls(generator=torch.Generator().manual_seed(seed), **kw)
    if heads:
        seed_zero_heads(model, torch.Generator().manual_seed(seed + 100))
    return model


def golden_lhbdc() -> dict:
    from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder

    coder = LHBDCCoder(_seeded(LHBDC, 11, heads=False, N=32), device="cpu")
    x1, xc, x2 = _frames()
    bits, x_hat = coder.encode_recon(x1, xc, x2, rate_id=845)
    blob = bits.serialize()
    dec = coder.decode(x1, x2, type(bits).deserialize(blob))
    assert dec.equal(x_hat), "decode != encoder recon"
    return _record(blob, x_hat, xc)


def golden_flexrate() -> dict:
    from tpuvc_torch.models.flexrate import BidirFlowRef, FlexRateCoder

    coder = FlexRateCoder(_seeded(BidirFlowRef, 12, N=32), device="cpu")
    x1, xc, x2 = _frames(seed=8)
    bits, x_hat = coder.encode_recon(x1, xc, x2, n=1, l=0.5)
    blob = bits.serialize()
    dec = coder.decode(x1, x2, type(bits).deserialize(blob))
    assert dec.equal(x_hat), "decode != encoder recon"
    return _record(blob, x_hat, xc)


def golden_deform_b() -> dict:
    from tpuvc_torch.models.deform_b import DeformB, DeformBCoder

    model = _seeded(DeformB, 13, feature_channels=(8, 16, 24), N=32, M=32, levels=3,
                    groups=(4, 4, 8, 16))
    coder = DeformBCoder(model, device="cpu")
    x1, xc, x2 = _frames(seed=9)
    bits, x_hat = coder.encode_recon(x1, x2, xc, s=1.0)
    blob = bits.serialize()
    dec = coder.decode(x1, x2, type(bits).deserialize(blob))
    assert dec.equal(x_hat), "decode != encoder recon"
    return _record(blob, x_hat, xc)


def golden_flowguided_b() -> dict:
    from tpuvc_torch.models.flowguided_b import FlowGuidedB, FlowGuidedBCoder

    model = _seeded(FlowGuidedB, 14, feature_channels=(16, 32, 48), N=32, M=32, levels=3,
                    groups=(4, 4, 8, 16))
    coder = FlowGuidedBCoder(model, device="cpu")
    x1, xc, x2 = _frames(seed=10)
    bits, x_hat = coder.encode_recon(x1, x2, xc, s=1.0, scale1=0.5, scale2=-0.5)
    blob = bits.serialize()
    dec = coder.decode(x1, x2, type(bits).deserialize(blob))
    assert dec.equal(x_hat), "decode != encoder recon"
    return _record(blob, x_hat, xc)


def golden_elic() -> dict:
    from tpuvc_torch.models.elic import ELIC, ELICCoder

    coder = ELICCoder(_seeded(ELIC, 16, heads=False, N=32, M=48, groups=(4, 4, 8, 32)),
                      device="cpu")
    xc = _frames(seed=12)[1]
    out = coder.compress(xc)
    y_strings, z_string = out["strings"]
    h = hashlib.sha256()
    for s in list(y_strings) + [z_string]:
        h.update(len(s).to_bytes(4, "little"))
        h.update(s)
    x_dec = coder.decompress(out["strings"], out["shape"])
    assert x_dec.equal(coder.synthesize(out["y_hat"])), "decompress != encoder-side synthesis"
    total = sum(len(s) for s in list(y_strings) + [z_string])
    return {
        "stream_sha256": h.hexdigest(),
        "stream_len": total,
        "psnr": round(_psnr(x_dec.clamp(0.0, 1.0), xc), 4),
    }


def golden_dmc() -> dict:
    from tpuvc_torch.models.dmc import PFrameDMC, PFrameDMCCoder

    coder = PFrameDMCCoder(_seeded(PFrameDMC, 15, heads=False, feat=16, N=32), device="cpu")
    try:
        ref, xc, _ = _frames((1, 128, 128, 3), seed=11)
        dpb = {"ref_frame": ref, "ref_feature": None, "ref_down_ratio": 1.0}
        bits, enc_dpb = coder.encode(xc, dpb, ratio=1.0, q=0.5)
        blob = bits.serialize()
        _, dec_dpb = coder.decode(dpb, type(bits).deserialize(blob))
    finally:
        coder.close()
    assert dec_dpb["ref_frame"].equal(enc_dpb["ref_frame"]), "decode != encoder recon"
    return _record(blob, dec_dpb["ref_frame"], xc)


CASES = {
    "lhbdc": golden_lhbdc,
    "flexrate": golden_flexrate,
    "deform_b": golden_deform_b,
    "flowguided_b": golden_flowguided_b,
    "elic": golden_elic,
    "dmc": golden_dmc,
}


def record(name: str) -> dict:
    """The golden record of one family, on one CPU thread."""
    import torch

    torch.set_num_threads(1)
    with torch.no_grad():
        return CASES[name]()
