"""Configuration of the port (fgvc_tpu/config.py): the test settings of the
ported slices, and the training recipe.

Field names and defaults follow fgvc_tpu.config's.  Every propagation mode
is ported: attention_impl 'pallas' (the top-k attention kernel), 'tiled',
'dense', 'c2f' and 'flow_guided' (plain PyTorch, as XLA code in fgvc_tpu),
the four topk_impl, and with_first_neighbor=False; both upload formats,
'rgb' and 'yuv420' (I420 planes encoded on the host, decoded on the device).
``check_ported`` raises ValueError for a value no package accepts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TestConfig:
    precede_frames: int = 5
    topk: int = 10
    temperature: float = 0.07
    neighbor_range: int = 30    # full diameter: radius = neighbor_range // 2
    step: int = 512             # the reference's chunk size; no effect on the kernel path
    with_first: bool = True     # False invalidates the frame-0 key slot
    with_first_neighbor: bool = True
    with_norm: bool = True
    hard_prop: bool = False
    sigma: float = 6.0          # gaussian query heatmap std-dev (input px)
    input_size: Tuple[int, int] = (256, 256)
    attention_impl: str = "pallas"
    save_mem: bool = False
    decode_impl: str = "upsample"
    tile: int = 32              # query tile edge: 'tiled' takes it, the kernel caps it at 16
    upload_format: str = "rgb"
    matmul_precision: str = "highest"
    # 'heatmap': a point is visible at frame t where its propagated map's
    # peak over its query frame's is >= visibility_threshold; 'none': never
    visibility_mode: str = "none"
    visibility_threshold: float = 0.5
    preprocess: str = "lab"
    # top-k of attention_impl 'tiled': 'exact' (lax.top_k's members),
    # 'segmented' (segment-max prefiltered, thresholded value mix), 'approx'
    # and 'certified' (jax.lax.approx_max_k, which is exact off the TPU:
    # both take exact candidates here, and 'certified' always certifies)
    topk_impl: str = "exact"
    # attention_impl 'c2f': coarse stage on c2f_scale x average-pooled
    # features, fine patches of (2 * radius_fine + 1)^2 around each coarse
    # match, c2f_step query pixels a chunk
    c2f_scale: int = 4
    radius_fine: int = 12
    c2f_step: int = 256
    # attention_impl 'flow_guided': a (2 * flow_radius + 1)^2 window per key
    # frame around the chained feature flow, flow_step query pixels a chunk
    flow_radius: int = 6
    flow_step: int = 1024


DAVIS_TEST_CFG = TestConfig(step=512)
KINETICS_TEST_CFG = TestConfig(step=128)
JHMDB_TEST_CFG = TestConfig(step=128, input_size=(320, 320))
BADJA_TEST_CFG = TestConfig(step=128)

ATTENTION_IMPLS = ("pallas", "tiled", "dense", "c2f", "flow_guided")
TOPK_IMPLS = ("exact", "segmented", "certified", "approx")

PREPROCESS = ("lab", "imagenet")
# the host -> device wire format: uint8 RGB (3 B/px) or I420 planes (1.5 B/px)
UPLOAD_FORMATS = ("rgb", "yuv420")
VISIBILITY_MODES = ("none", "heatmap")
# 'window' decodes as 'upsample' does: fgvc_tpu's decode branches on 'coarse' only
DECODE_IMPLS = ("upsample", "window", "coarse")


MATMUL_PRECISIONS = ("highest", "high", "default")


def check_ported(cfg: TestConfig) -> None:
    """Raise ValueError for a matmul_precision outside the three modes, a
    preprocess other than 'lab' and 'imagenet', a visibility_mode other than
    'none' and 'heatmap', a decode_impl outside DECODE_IMPLS, an
    attention_impl outside ATTENTION_IMPLS, a topk_impl outside TOPK_IMPLS or
    an upload_format outside UPLOAD_FORMATS."""
    if cfg.matmul_precision not in MATMUL_PRECISIONS:
        raise ValueError(
            f"matmul_precision must be one of {MATMUL_PRECISIONS}, "
            f"got {cfg.matmul_precision!r}"
        )
    if cfg.preprocess not in PREPROCESS:
        raise ValueError(
            f"preprocess must be 'lab' or 'imagenet', got {cfg.preprocess!r}"
        )
    if cfg.visibility_mode not in VISIBILITY_MODES:
        raise ValueError(
            f"visibility_mode must be 'none' or 'heatmap', got {cfg.visibility_mode!r}"
        )
    if cfg.decode_impl not in DECODE_IMPLS:
        raise ValueError(f"decode_impl must be one of {DECODE_IMPLS}, got {cfg.decode_impl!r}")
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"attention_impl must be one of {ATTENTION_IMPLS}, got {cfg.attention_impl!r}"
        )
    if cfg.topk_impl not in TOPK_IMPLS:
        raise ValueError(f"topk_impl must be one of {TOPK_IMPLS}, got {cfg.topk_impl!r}")
    if cfg.upload_format not in UPLOAD_FORMATS:
        raise ValueError(
            f"upload_format must be one of {UPLOAD_FORMATS}, got {cfg.upload_format!r}"
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The mixed-training recipe (fgvc_tpu.config.TrainConfig), every field
    and default: reconstruction at radius 24 on stride-2 features, flow
    distillation from a frozen teacher, adversarial correlation alignment;
    Adam with cosine annealing (no warmup, as the released recipe ran)."""

    # model
    radius: int = 24
    downsample_rate: int = 2
    scale: int = 2              # sup-branch sampling stride on full-res flow
    temperature_t: float = 0.07
    rec_weight: float = 20.0    # smooth-l1 photometric scaling
    loss_weight_l1: float = 1.0
    loss_weight_sup: float = 1.0
    loss_weight_corr_da: float = 1.0
    bilateral: bool = False
    norm: bool = True
    # optimisation
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    max_epochs: int = 30
    warmup: Optional[str] = None   # None: pure cosine; 'linear': warmup first
    warmup_epochs: int = 10
    warmup_ratio: float = 0.1
    check_numerics: bool = False   # raise on the first non-finite step
    min_lr_ratio: float = 0.001
    batch_size: int = 4
    crop_size: int = 256
    seed: int = 0
    grad_clip: Optional[float] = None
    loss_scale: float = 1.0
    # precision of the correlation products only; the backbone is float32
    matmul_precision: str = "high"
    compute_dtype: str = "float32"
    remat: bool = False            # recompute the student's activations
    fused_encoder: bool = False    # one student pass over rec + sup (union BN)


def config_from_file(path: str, base):
    """Overlay a JSON object of config fields onto `base` (a TestConfig or
    TrainConfig).  Unknown keys fail loudly; lists become tuples for
    tuple-typed fields.  CLI layering: preset -> file -> explicit flags."""
    import json

    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: expected a JSON object of config fields")
    valid = {f.name for f in dataclasses.fields(base)}
    unknown = sorted(set(data) - valid)
    if unknown:
        raise ValueError(
            f"{path}: unknown {type(base).__name__} field(s) {unknown}; "
            f"valid: {sorted(valid)}"
        )
    coerced = {
        k: tuple(v) if isinstance(v, list) and isinstance(getattr(base, k), tuple) else v
        for k, v in data.items()
    }
    return dataclasses.replace(base, **coerced)


def check_train_ported(cfg: TrainConfig, *, world: int = 1) -> None:
    """Raise ValueError for a value no package accepts: a compute dtype
    other than float32 or bfloat16, an unknown matmul precision or warmup,
    or a global batch that does not divide over the `world` processes of a
    data-parallel run (JAX's batch sharding fails there too)."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"compute_dtype must be 'float32' or 'bfloat16', got {cfg.compute_dtype!r}"
        )
    if cfg.matmul_precision not in MATMUL_PRECISIONS:
        raise ValueError(
            f"matmul_precision must be one of {MATMUL_PRECISIONS}, "
            f"got {cfg.matmul_precision!r}"
        )
    if cfg.warmup not in (None, "linear"):
        raise ValueError(f"warmup must be None or 'linear', got {cfg.warmup!r}")
    if world < 1 or cfg.batch_size % world:
        raise ValueError(
            f"the global batch of {cfg.batch_size} does not divide over {world} processes"
        )
