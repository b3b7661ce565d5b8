"""Environment collection and logging helpers of the port
(fgvc_tpu/utils/env.py: collect_env, get_root_logger).  fgvc_tpu's
force_platform picks a JAX platform; the port's entry points take a
`device` argument instead."""

from __future__ import annotations

import logging
import os
import platform
import shutil
import subprocess
import sys
from typing import Dict, Optional

import torch


def card_info() -> Optional[str]:
    """The first card's name and power limit as nvidia-smi gives them
    (``--query-gpu=name,power.limit --format=csv,noheader``), or None where
    there is no card or no nvidia-smi."""
    if not torch.cuda.is_available() or shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0] if out else None


def collect_env() -> Dict[str, str]:
    info = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "cuda_available": str(torch.cuda.is_available()),
        "devices": ", ".join(
            torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())
        ) or "cpu",
    }
    card = card_info()
    if card is not None:
        info["card"] = card
    return info


def get_root_logger(log_file: Optional[str] = None, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("fgvc_tpu_torch")
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
