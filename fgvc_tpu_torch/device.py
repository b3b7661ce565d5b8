"""Device and precision policy of the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

from fgvc_tpu_torch.config import MATMUL_PRECISIONS


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another.  Raises where no card is present and none was named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU"
        )
    return dev


def set_matmul_precision(precision: str) -> None:
    """TestConfig.matmul_precision reaches only the top-k attention kernel
    (its compute_dtype), as in fgvc_tpu, where it never reaches the
    backbone: in every mode the backbone and every other float32 product run
    in full float32, with TF32 off for matrix products AND for cuDNN
    convolutions (PyTorch's cuDNN default is TF32)."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(
            f"matmul_precision must be one of {MATMUL_PRECISIONS}, got {precision!r}"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_deterministic() -> None:
    """cuDNN convolutions with deterministic algorithms (no atomics in their
    backward): with them a training run repeats itself on the card, and a
    resumed run the uninterrupted one."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
