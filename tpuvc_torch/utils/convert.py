"""tpuvc (flax) parameter trees <-> tpuvc_torch state dicts.

The port names its submodules as tpuvc's flax modules are named, so a flax
parameter path becomes a state-dict key by joining it with dots, except:

- flax module lists ``g_a_layers_3`` (and ELIC's ``h_a_layers`` and
  ``h_s_layers``, CondELIC's ``g_s3_blocks`` and ``prior_fusion_blocks``,
  both codecs' ``entropy_parameters``, ``channel_context_models`` and
  ``context_prediction_models``, and DMC's ``mv_g_a``, ``mv_g_s``,
  ``feat_blocks``, ``ctx_refine``, ``recon_head`` and ``adaptors``) are
  ``nn.ModuleList`` entries ``g_a_layers.3`` here;
- conv kernels are HWIO in flax and OIHW here (``kernel`` -> ``weight``);
  a ``DeformConv``'s HWIO kernel is named ``weight`` in flax too (the only
  4-D ``weight`` in tpuvc's trees, under ``DeformConv_0`` in v4 and under
  ``deconv_l{1,2,3}_{1,2}`` in v3);
  SPyNet's ``conv{i}_kernel``/``conv{i}_bias`` are ``conv{i}.weight/bias``;
- a transposed conv's flax kernel (kH, kW, in, out) is the spatially
  flipped torch ``ConvTranspose2d`` weight (in, out, kH, kW), and tpuvc's
  ``Deconv`` keeps it in a ``ConvTranspose_0`` submodule that the port folds
  into the Deconv itself;
- GDN ``beta``/``gamma``, the entropy bottleneck's ``matrix_i``,
  ``bias_i``, ``factor_i`` and ``quantiles``, and CondELIC's ``Gain``,
  ``InverseGain``, ``HyperGain`` and ``InverseHyperGain``, Flex-Rate's
  ``gain_matrix`` and DMC's ``gain`` / ``inv_gain`` copy verbatim
  (same reparametrisation, same orientation).

``params_to_jax`` maps a module's parameters back to tpuvc's tree, by the
type of the module that holds each one, so a checkpoint the port trains
loads in both packages.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LISTS = (
    "g_a_layers", "g_s_layers", "h_a_convs", "h_a_layers", "h_s_layers",
    "g_s3_blocks", "prior_fusion_blocks", "entropy_parameters",
    "channel_context_models", "context_prediction_models",
    # PFrameDMC and its _FourPartCoders
    "mv_g_a", "mv_g_s", "feat_blocks", "ctx_refine", "recon_head", "adaptors",
)


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (str(k),))
    else:
        yield path, tree


def _parts(path) -> list[str]:
    out = []
    for seg in path:
        m = re.fullmatch(r"(.+)_(\d+)", seg)
        if m and m.group(1) in _LISTS:
            out += [m.group(1), m.group(2)]
        else:
            out.append(seg)
    return out


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A flax parameter tree (``variables`` or ``variables["params"]``, numpy
    or JAX arrays) -> state dict for the matching tpuvc_torch module."""
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        *parts, name = _parts(path)
        spy = re.fullmatch(r"conv(\d+)_(kernel|bias)", name)
        if spy:
            parts.append(f"conv{spy.group(1)}")
            name = spy.group(2)
        if parts and parts[-1] == "ConvTranspose_0":
            parts.pop()
            if name == "kernel":
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif name == "kernel" or (name == "weight" and arr.ndim == 4):
            arr = arr.transpose(3, 2, 0, 1)
        if name == "kernel":
            name = "weight"
        key = ".".join(parts + [name])
        out[key] = torch.tensor(np.ascontiguousarray(arr))
    return out


def _flax_path(torch_name: str) -> list[str]:
    """Module path ``g_a_layers.3.Conv_0`` -> flax segments
    ``["g_a_layers_3", "Conv_0"]``."""
    out: list[str] = []
    for seg in torch_name.split(".") if torch_name else []:
        if seg.isdigit() and out and out[-1] in _LISTS:
            out[-1] = f"{out[-1]}_{seg}"
        else:
            out.append(seg)
    return out


def params_to_jax(module: torch.nn.Module) -> dict:
    """A tpuvc_torch module's parameters -> tpuvc's flax parameter tree
    (nested dicts of float32 numpy arrays, without the ``params`` level):
    the inverse of :func:`params_from_jax`.

    By the type of the holding module: a ``Conv``'s or a
    ``CheckerboardConv``'s OIHW weight becomes an HWIO ``kernel`` (``conv{i}_kernel`` / ``conv{i}_bias`` in a SPyNet
    block), a ``DeformConv``'s stays an HWIO ``weight``, a ``Deconv``'s
    weight and bias go to a ``ConvTranspose_0`` child, the kernel
    spatially flipped; everything else is copied."""
    from tpuvc_torch.models.layers import Conv, Deconv
    from tpuvc_torch.models.spynet import BasicBlock
    from tpuvc_torch.ops.checkerboard import CheckerboardConv
    from tpuvc_torch.ops.deform import DeformConv

    modules = dict(module.named_modules())
    tree: dict = {}
    for mname, m in modules.items():
        path = _flax_path(mname)
        parent = modules.get(mname.rpartition(".")[0]) if mname else None
        for pname, p in m.named_parameters(recurse=False):
            arr = p.detach().cpu().float().numpy()
            where, name = path, pname
            if isinstance(m, Deconv):
                where = path + ["ConvTranspose_0"]
                if pname == "weight":
                    arr, name = arr.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
            elif isinstance(m, (Conv, CheckerboardConv, DeformConv)) and pname == "weight":
                arr = arr.transpose(2, 3, 1, 0)
                name = "weight" if isinstance(m, DeformConv) else "kernel"
            if isinstance(m, Conv) and isinstance(parent, BasicBlock):
                where, name = path[:-1], f"{path[-1]}_{name}"
            node = tree
            for seg in where:
                node = node.setdefault(seg, {})
            node[name] = np.array(arr, order="C")  # a copy: no view of the live weights
    return tree
