"""Convert a reference PyTorch checkpoint to a tpuvc checkpoint (port of
tpuvc.cli.import_torch).

    python -m tpuvc_torch.cli.import_torch --input compression_1626.pth \
        --output weights/compression_1626.msgpack --family lhbdc

Reads the reference's whole-model ``.pth`` (LHBDC/train.py:205-215 format,
or a raw state dict), maps it onto tpuvc's parameter tree
(``tpuvc_torch.utils.torch_import``) and writes it in tpuvc's checkpoint
format, byte for byte what ``python -m tpuvc.cli.import_torch`` writes, so
the ``encode_b``/``decode_b``/``test``/``test_image`` CLIs of either
package load the reference's trained weights. Host only: no device is used.
"""

from __future__ import annotations

import argparse


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def main(argv=None):
    """Returns (the parameter tree, the ImportReport)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True, help=".pth checkpoint path")
    ap.add_argument("--output", required=True, help="tpuvc checkpoint path")
    ap.add_argument(
        "--family", default="lhbdc",
        choices=[
            "lhbdc", "flexrate", "elic",
            "deform_b", "icip2023", "flowguided", "icip2024",
        ],
        help="codec family the checkpoint belongs to "
             "(elic = intra model; icip2023/icip2024 are aliases for "
             "deform_b/flowguided)",
    )
    args = ap.parse_args(argv)

    from tpuvc_torch.utils.checkpoint import save_checkpoint
    from tpuvc_torch.utils.torch_import import load_pth

    params, report = load_pth(args.input, args.family)
    print(f"mapped {_count_leaves(params)} parameter tensors; "
          f"skipped {len(report.skipped)} rebuilt buffers")
    unused = getattr(report, "unmapped", [])
    if unused:
        print(f"WARNING: {len(unused)} unmapped keys, e.g. {unused[:5]}")
    save_checkpoint(args.output, {"params": params})
    print(f"wrote {args.output}")
    return params, report


if __name__ == "__main__":
    main()
