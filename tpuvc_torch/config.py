"""Unified config schema: one dataclass tree, YAML-loadable, CLI-overridable
(the port's copy of tpuvc.config; same fields, same defaults).

Replaces the reference's three config generations (SURVEY.md C1/C2):
argparse (LHBDC/test/testing.py:35-59), module constants
(ICIP2024/src/train/config.py), and hydra/omegaconf groups
(ICIP2023/configs/test.yaml + configs/dataset/UVG.yaml). Every knob those
surfaces expose exists here; ``apply_overrides`` implements hydra-style
dotted ``key.sub=value`` assignments.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


#: UVG dataset group (ICIP2023/configs/dataset/UVG.yaml:5-19).
UVG_SEQUENCES = {
    "beauty": 600,
    "bosphorus": 600,
    "honeybee": 600,
    "jockey": 600,
    "readysetgo": 600,
    "shakendry": 300,
    "yachtride": 600,
}


@dataclass
class DatasetConfig:
    name: str = "UVG"
    root: str = "/data/UVG"
    sequences: dict = field(default_factory=lambda: dict(UVG_SEQUENCES))
    gop: int = 16
    width: int = 1920
    height: int = 1080


@dataclass
class ModelConfig:
    family: str = "flowguided_b"  # lhbdc | flexrate | deform_b | flowguided_b
    N: int = 128
    M: int = 128
    levels: int = 5
    feature_channels: tuple = (64, 96, 128)


@dataclass
class TestConfig:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    levels: tuple = (0, 1, 2, 3, 4)
    #: beta (distortion weight) per level (ICIP2024/src/train/config.py:42).
    betas_mse: tuple = (0.0056, 0.0107, 0.0207, 0.0400, 0.0772)
    intra_weights: str = "weights/intra"
    inter_weights: str = "weights/inter"
    results_csv: str = "results.csv"
    seed: int = 0
    adaptive_down_ratio: bool = True
    #: also record MS-SSIM per frame (the LHBDC MS-SSIM RD protocol,
    #: LHBDC/results/mssim_bpp.txt) in the infographic ledger.
    eval_msssim: bool = False
    #: level-batched GOP scheduling (the bench.py performance path:
    #: independent frames in a hierarchy level share one batched forward).
    #: Covers the largest k*gop+1 prefix of each sequence; the sequential
    #: runner remains the exact reference protocol. Disables the v4
    #: per-frame adaptive down-ratio search.
    level_batched: bool = False
    #: per-forward batch cap for the level-batched path.
    max_batch: int = 8
    #: GOPs coded together per window in the level-batched path: the same
    #: hierarchy level across the window's GOPs is batched in one forward,
    #: so narrow levels also fill the device (scheduler.code_gops_batched).
    #: Bounded by device memory: each window keeps window_gops*gop+1
    #: decoded frames on the device (~25 MB each at 1080p).
    window_gops: int = 1
    #: DMC (model.family=dmc) low-delay eval: I-frame period (the OJSP
    #: harness codes I every 32), candidate fractional down ratios for the
    #: adaptive search (the full OJSP grid is 1..8.75 step 0.25), and an
    #: optional per-frame diagnostics CSV
    #: (ratio/warp-PSNR/bpp split, OJSP2025/video_model.py:565-609).
    #: write RD-curve + per-frame PSNR/bpp figures next to the results CSV
    #: (LHBDC/test/testing.py:202-307, ICIP2024/src/testing.py:47-65).
    write_plots: bool = False
    dmc_intra_period: int = 32
    dmc_ratios: tuple = (1.0, 1.5, 2.0, 3.0, 4.0)
    dmc_diag_csv: str = ""
    device_count: int = 1
    output_dir: str = "outputs"
    #: hydra-style timestamped run directory (ICIP2023/configs/test.yaml:7-9,
    #: outputs/%Y-%m-%d/%H-%M-%S): when true, results/plots/logs land in
    #: output_dir/<date>/<time> so successive runs never overwrite.
    timestamped_output: bool = False
    #: "float32" | "bfloat16": layer compute dtype (tpuvc_torch.ops.precision).
    compute_dtype: str = "float32"


@dataclass
class TrainConfig:
    dataset_root: str = "/data/vimeo_septuplet"
    model: ModelConfig = field(default_factory=ModelConfig)
    batch_size: int = 8
    crop: int = 256
    lr: float = 1e-4
    aux_lr: float = 1e-3
    lr_drop_step: int = 500_000
    total_steps: int = 750_000
    stage2_start: int = 350_000
    grad_clip: float = 1.0
    #: 'mse' (reference objective) | 'ms_ssim' (1 - MS-SSIM distortion,
    #: the objective behind the reference's published MS-SSIM curves;
    #: needs crop >= 176).
    distortion: str = "mse"
    #: LHBDC-family rate weight (lambda, LHBDC/encode_B.py:27); for
    #: ms_ssim use an MSSSIM_ALPHAS point (tpuvc.train.loss; not ported yet).
    alpha: float = 1626.0
    #: ELIC intra rate weight (lambda in lambda*255^2*MSE + bpp; the
    #: compressai-style quality grid — 0.0207 ~ mid-quality). Pairs with
    #: an LHBDC-family alpha via i_lambda ~ alpha / 255^2.
    i_lambda: float = 0.0207
    #: ELIC intra: train with the coding-consistent stage-2 rounding
    #: (forward_stage2 semantics, ICIP2023/src/model/elic.py:247-306 —
    #: groups quantized AROUND MEANS feed g_s and the channel context,
    #: exactly as the real coder reconstructs). Stage-1-only training
    #: tunes g_s for around-zero latents, which the real bitstream path
    #: never produces: measured 7.4 dB real-vs-forward intra recon drop
    #: at 2k-step weights (PERF.md r5 gap diagnosis). The reference's
    #: own schedule finetunes with forward_stage2 for the same reason.
    i_stage2: bool = True
    #: recursive-trainer rate weight (beta, ICIP2024 config.py:42).
    beta: float = 0.04
    #: DMC trainer: P-frames per cascaded step (batch windows are
    #: n_pframes+1 consecutive frames).
    n_pframes: int = 2
    #: DMC trainer: weight of the warp-prediction MSE bootstrapping term.
    warp_weight: float = 0.0
    #: host decode threads per batch (reference DataLoader num_workers=4,
    #: LHBDC/test/testing.py:117-120); sample stream is worker-independent.
    workers: int = 4
    #: batches prepared ahead by a background thread.
    prefetch: int = 2
    #: >0: drop steps with NaN/inf gradients (optax.apply_if_finite with
    #: this many consecutive errors tolerated) instead of poisoning params.
    skip_nonfinite: int = 100
    #: >0: ReduceLROnPlateau on the main optimizer (LHBDC reference
    #: schedule, factor 0.5, LHBDC/test/utils.py:359-361), measured in
    #: non-improving train steps; 0 keeps the step-wise lr drop only.
    plateau_patience: int = 0
    val_every: int = 10_000
    #: optional directory of validation sequences (PNG frame dirs); when
    #: absent, synthetic clips drive the BD-rate checkpointing signal.
    val_root: str = ""
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    #: "float32" | "bfloat16": layer compute dtype (tpuvc_torch.ops.precision).
    compute_dtype: str = "float32"


def apply_overrides(cfg, overrides: list[str]):
    """Apply ``a.b=c`` style overrides in place (hydra-like)."""
    for ov in overrides:
        key, eq, raw = ov.partition("=")
        if eq != "=":
            raise ValueError(f"bad override (want key.sub=value): {ov}")
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        current = getattr(obj, parts[-1])
        value = _parse(raw, current)
        setattr(obj, parts[-1], value)
    return cfg


def _parse(raw: str, current):
    import ast

    if isinstance(current, str):
        return raw
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def load_yaml(path: str, cls=TestConfig):
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return _from_dict(cls, data)


def _from_dict(cls, data: dict):
    kwargs = {}
    for f_ in dataclasses.fields(cls):
        if f_.name not in data:
            continue
        v = data[f_.name]
        if dataclasses.is_dataclass(f_.type) and isinstance(v, dict):
            v = _from_dict(f_.type, v)
        elif f_.name in ("dataset", "model") and isinstance(v, dict):
            sub = {"dataset": DatasetConfig, "model": ModelConfig}[f_.name]
            v = _from_dict(sub, v)
        kwargs[f_.name] = v
    return cls(**kwargs)
