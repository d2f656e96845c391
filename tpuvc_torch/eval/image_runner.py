"""Still-image (Kodak-style) RD evaluation for the intra codec (port of
tpuvc.eval.image_runner).

Parity: the reference evaluates its I-frame models on Kodak via
compressai_image_compress (LHBDC/test/utils.py:206-247); the protocol
matches the video eval — PSNR on uint8-rounded pixels over the unpadded
crop, bpp = likelihood bits / unpadded pixels.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpuvc_torch.eval.infographic import TestInfographic
from tpuvc_torch.eval.metrics import msssim, psnr_uint8


def eval_images(
    dataset,
    intra_fn: Callable,
    name: str = "kodak",
    level: int = 0,
    info: TestInfographic | None = None,
    compute_msssim: bool = False,
):
    """Evaluate every image in ``dataset`` with ``intra_fn``.

    Args:
      dataset: indexable of padded (1, H', W', 3) float32 numpy arrays with
        a ``size(idx) -> (H, W)`` unpadded-size accessor
        (tpuvc_torch.data.kodak.ImageFolder / SyntheticImages).
      intra_fn(x) -> (x_hat, size_bits): ``x`` the numpy image; ``x_hat``
        a tensor on any device (or an array), brought to the host once per
        image; ``size_bits`` a number or a scalar tensor.

    Returns (psnr_list, bpp_list) ordered by image index.
    """
    psnr_list, bpp_list = [], []
    for idx in range(len(dataset)):
        x = dataset[idx]
        h, w = dataset.size(idx)
        dec, bits = intra_fn(x)
        dec_t = torch.as_tensor(dec).detach().float().cpu().clamp(0.0, 1.0)[:, :h, :w]
        ref_t = torch.from_numpy(x[:, :h, :w])
        cur_psnr = float(psnr_uint8(ref_t, dec_t))
        bpp = float(bits) / (h * w)
        psnr_list.append(cur_psnr)
        bpp_list.append(bpp)
        if info is not None:
            extra = {}
            if compute_msssim:
                extra["msssim"] = float(msssim(ref_t, dec_t))
            info.update(
                video=name, level=level, frame_num=idx, frame_type="I",
                psnr=cur_psnr, size=float(bits), pixels=h * w, **extra,
            )
    return psnr_list, bpp_list
