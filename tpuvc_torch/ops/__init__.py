from tpuvc_torch.ops.pad import pad_to_multiple, unpad
from tpuvc_torch.ops import warp  # the module, callable as its warp()
from tpuvc_torch.ops.resample import (
    avg_pool2d,
    bilinear_resize,
    upsample2x_flow,
    pixel_shuffle,
    pixel_unshuffle,
)

__all__ = [
    "pad_to_multiple",
    "unpad",
    "warp",
    "avg_pool2d",
    "bilinear_resize",
    "upsample2x_flow",
    "pixel_shuffle",
    "pixel_unshuffle",
]
