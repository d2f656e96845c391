"""Results file writers in the reference's published formats (port of
tpuvc.eval.results_io; the same bytes).

- ``write_rd_txt``: the psnr_bpp.txt / mssim_bpp.txt layout, a
  '#'-commented header, aggregate (bpp, metric) rows, then per-sequence
  sections.
- ``PerFrameDiagnostics``: the OJSP per-frame diagnostics CSV, one row per
  coded frame with the chosen down ratio, the warp-only prediction's PSNR
  and the bit split.
"""

from __future__ import annotations

import csv


def write_rd_txt(
    path: str,
    title: str,
    metric_name: str,
    aggregate: list[tuple[float, float]],
    per_sequence: dict[str, list[tuple[float, float]]] | None = None,
):
    """Write a psnr_bpp.txt-style file: (bpp, metric) rows."""
    with open(path, "w") as f:
        f.write(f"# Rate-distortion data for {title} on UVG.\n")
        f.write("# The first column contains bits per pixel (bpp) values.\n")
        f.write(f"# The second column contains {metric_name}\n\n")
        for bpp, m in aggregate:
            f.write(f"{bpp:.4f},    {m:.2f}\n")
        if per_sequence:
            for seq, rows in per_sequence.items():
                f.write(f"\n\n# {seq} sequence\n\n")
                for bpp, m in rows:
                    f.write(f"{bpp:.4f},    {m:.2f}\n")
    return path


class PerFrameDiagnostics:
    """OJSP-style per-frame instrumentation ledger -> CSV."""

    FIELDS = [
        "frame", "type", "down_ratio", "psnr", "warp_psnr",
        "bits", "bpp", "bits_mv", "bits_y",
    ]

    def __init__(self):
        self.rows: list[dict] = []

    def update(self, **kw):
        self.rows.append({k: kw.get(k) for k in self.FIELDS})

    def write(self, path: str):
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.FIELDS)
            w.writeheader()
            w.writerows(self.rows)
        return path
