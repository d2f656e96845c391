"""RD-curve and per-frame diagnostic plots (port of tpuvc.eval.plots).

Parity: the reference's LHBDC/test/testing.py:202-307 (RD curves vs
baseline codecs) and ICIP2024/src/testing.py:47-65 (per-frame PSNR/bpp
twin-axis figures). Anchors come from tpuvc_torch.eval.bd_rate.ANCHORS.

matplotlib is imported when a figure is drawn, with the ``Agg`` backend, so
the package imports on machines without it; :func:`require_matplotlib`
says so up front.
"""

from __future__ import annotations

from tpuvc_torch.eval.bd_rate import ANCHORS


def require_matplotlib() -> None:
    """Raise ImportError, naming the package, when matplotlib is missing."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "plots need matplotlib, which is not installed here"
        ) from e


def _pyplot():
    require_matplotlib()
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def rd_curve(
    points: dict[str, tuple[list[float], list[float]]],
    path: str,
    title: str = "UVG RD",
    anchors: tuple[str, ...] = ("elfvc", "lhbdc", "flex_icip2022"),
):
    """points: name -> (bpp list, psnr list). Writes a PNG."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    for name in anchors:
        if name in ANCHORS:
            r, p = ANCHORS[name]
            ax.plot(r, p, "--", marker="x", label=name, alpha=0.6)
    for name, (r, p) in points.items():
        ax.plot(r, p, marker="o", label=name, linewidth=2)
    ax.set_xlabel("bpp")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(title)
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def per_frame_figure(psnrs, sizes, num_pixels: int, path: str, title: str = ""):
    """Twin-axis per-frame PSNR / bpp figure."""
    plt = _pyplot()
    fig, ax1 = plt.subplots(figsize=(9, 4))
    frames = range(len(psnrs))
    ax1.plot(frames, psnrs, color="tab:blue", label="PSNR")
    ax1.set_xlabel("frame")
    ax1.set_ylabel("PSNR (dB)", color="tab:blue")
    ax2 = ax1.twinx()
    ax2.plot(
        frames, [s / num_pixels for s in sizes], color="tab:red", label="bpp"
    )
    ax2.set_ylabel("bpp", color="tab:red")
    ax1.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path
