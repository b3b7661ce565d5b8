"""Test configuration of the port (the slice's fields of fgvc_tpu/config.py).

Field names and defaults follow fgvc_tpu.config.TestConfig.  Knobs whose other
settings this package does not run yet keep their field, and
``check_ported`` raises NotImplementedError for a value other than the main
path's, naming the slice of ROADMAP.md that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TestConfig:
    precede_frames: int = 5
    topk: int = 10
    temperature: float = 0.07
    neighbor_range: int = 30    # full diameter: radius = neighbor_range // 2
    with_first: bool = True     # False invalidates the frame-0 key slot
    with_first_neighbor: bool = True
    with_norm: bool = True
    hard_prop: bool = False
    sigma: float = 6.0          # gaussian query heatmap std-dev (input px)
    input_size: Tuple[int, int] = (256, 256)
    attention_impl: str = "pallas"
    save_mem: bool = False
    decode_impl: str = "upsample"
    tile: int = 32              # query tile edge; the kernel caps it at 16
    upload_format: str = "rgb"
    matmul_precision: str = "highest"
    visibility_mode: str = "none"
    preprocess: str = "lab"


DAVIS_TEST_CFG = TestConfig()

# knob -> (the main path's value, the ROADMAP.md slice that ports the others)
_NOT_PORTED = {
    "attention_impl": ("pallas", "slice 6 (other propagation modes)"),
    "with_first_neighbor": (True, "slice 6 (other propagation modes)"),
    "decode_impl": ("upsample", "slice 5b (reproduce and host modes)"),
    "upload_format": ("rgb", "slice 5b (reproduce and host modes)"),
    "visibility_mode": ("none", "slice 5b (reproduce and host modes)"),
    "preprocess": ("lab", "slice 9 (zoo and RAFT)"),
}


MATMUL_PRECISIONS = ("highest", "high", "default")


def check_ported(cfg: TestConfig) -> None:
    """Raise NotImplementedError for a knob set off the ported main path,
    and ValueError for a matmul_precision outside the three modes."""
    if cfg.matmul_precision not in MATMUL_PRECISIONS:
        raise ValueError(
            f"matmul_precision must be one of {MATMUL_PRECISIONS}, "
            f"got {cfg.matmul_precision!r}"
        )
    for name, (value, slice_name) in _NOT_PORTED.items():
        if getattr(cfg, name) != value:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not ported to fgvc_tpu_torch "
                f"yet (only {value!r}); it comes with {slice_name}"
            )
