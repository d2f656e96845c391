"""Frame-level results ledger and aggregations (port of
tpuvc.eval.infographic, without pandas).

One row per coded frame; the aggregations are tpuvc's pandas group-bys
(groups sorted by key, means by pandas' compensated summation), returned
as lists of row dicts in pandas' ``to_dict("records")`` layout.
``results_csv`` writes the ICIP-style results CSV (level, sequence, psnr,
bpp) with the same bytes as tpuvc's ``DataFrame.to_csv``. tpuvc's
``to_excel`` is not ported (ROADMAP.md queue A, A16).
"""

from __future__ import annotations

import csv


def _group_means(rows: list[dict], keys: tuple[str, ...], cols=("psnr", "bpp")) -> list[dict]:
    """pandas ``groupby(keys)[cols].mean().reset_index()``: groups in sorted
    key order, each mean a Kahan-compensated float64 sum in row order
    divided by the count (pandas' ``group_mean``), so the floats are the
    same to the last bit."""
    groups: dict = {}
    for r in rows:
        groups.setdefault(tuple(r[k] for k in keys), []).append(r)
    out = []
    for key in sorted(groups):
        means = {}
        for c in cols:
            total = comp = 0.0
            for r in groups[key]:
                y = float(r[c]) - comp
                t = total + y
                comp = t - total - y
                if comp != comp:  # NaN: pandas drops the compensation
                    comp = 0.0
                total = t
            means[c] = total / len(groups[key])
        out.append({**dict(zip(keys, key)), **means})
    return out


class TestInfographic:
    """Accumulates one row per coded frame, then aggregates."""

    __test__ = False  # not a pytest test class, whatever its name

    COLUMNS = ["video", "level", "frame_num", "type", "psnr", "size", "pixels"]

    def __init__(self, extra_columns: tuple[str, ...] = ()):
        self.columns = self.COLUMNS + list(extra_columns)
        self.rows: list[dict] = []

    def update(self, video, level, frame_num, frame_type, psnr, size, pixels,
               **extra) -> None:
        row = dict(
            video=video, level=level, frame_num=frame_num, type=frame_type,
            psnr=float(psnr), size=float(size), pixels=int(pixels),
        )
        row.update(extra)
        self.rows.append(row)

    def _with_bpp(self) -> list[dict]:
        return [{**r, "bpp": r["size"] / r["pixels"]} for r in self.rows]

    def per_level(self) -> list[dict]:
        """Mean PSNR and bpp per rate level (the headline RD points): the
        mean over videos of each video's mean."""
        return _group_means(self.per_video(), ("level",))

    def per_video(self) -> list[dict]:
        return _group_means(self._with_bpp(), ("level", "video"))

    def per_frame_type(self) -> list[dict]:
        return _group_means(self._with_bpp(), ("level", "type"))

    def results_csv(self, path) -> list[dict]:
        """Write the ICIP-style results CSV: level, sequence, psnr, bpp."""
        out = [
            {"level": r["level"], "sequence": r["video"], "psnr": r["psnr"], "bpp": r["bpp"]}
            for r in self.per_video()
        ]
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["level", "sequence", "psnr", "bpp"])
            for r in out:
                w.writerow([r["level"], r["sequence"], repr(r["psnr"]), repr(r["bpp"])])
        return out
