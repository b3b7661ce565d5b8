"""Training checkpoints (fgvc_tpu/core/checkpoint.py) as torch.save files.

    work_dir/step_{n}/state.pt    the trainer's payload at step n
    work_dir/latest, work_dir/best    pointer files naming a step_{n}

The payload (MixedTrainer.state_dict) holds the student's parameters, its
BatchNorm statistics, both discriminators, the Adam state and its step
count, the step and the teacher, so a resumed run continues exactly.
Orbax directories of the JAX package are not read: they reach the port as
an exported .pth.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(work_dir: str, trainer) -> str:
    """Write trainer.state_dict() to work_dir/step_{step} and point
    `latest` at it; returns the directory."""
    step = trainer.step
    path = os.path.abspath(os.path.join(work_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(trainer.state_dict(), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    write_pointer(work_dir, "latest", step)
    return path


def write_pointer(work_dir: str, name: str, step: int) -> None:
    with open(os.path.join(work_dir, name), "w") as f:
        f.write(f"step_{step}")


def _pointer(work_dir: str, name: str) -> Optional[str]:
    pointer = os.path.join(work_dir, name)
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        target = f.read().strip()
    path = os.path.join(work_dir, target)
    return path if os.path.exists(path) else None


def latest_checkpoint(work_dir: str) -> Optional[str]:
    return _pointer(work_dir, "latest")


def best_checkpoint(work_dir: str) -> Optional[str]:
    """The best-metric checkpoint that train_model's validation tracks."""
    return _pointer(work_dir, "best")


def resolve_checkpoint(path: str) -> str:
    """A step_{n} directory, given it or a `latest`/`best` pointer file."""
    if os.path.isfile(path) and os.path.basename(path) in ("latest", "best"):
        target = _pointer(os.path.dirname(path) or ".", os.path.basename(path))
        if target is None:
            raise FileNotFoundError(f"{path} points at no checkpoint")
        path = target
    if not os.path.isfile(os.path.join(path, STATE_FILE)):
        raise FileNotFoundError(f"{path} is not a training checkpoint (no {STATE_FILE})")
    return path


def load_payload(path: str) -> Dict:
    """The payload of a checkpoint directory or pointer, on the CPU."""
    return torch.load(os.path.join(resolve_checkpoint(path), STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, trainer) -> int:
    """Load a checkpoint into `trainer` (its optimizer made); returns the
    step."""
    trainer.load_state_dict(load_payload(path))
    return trainer.step


def student_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The trained student's ResNet state dict (parameters and BatchNorm
    statistics) of a checkpoint directory or pointer."""
    payload = load_payload(path)
    return {**payload["params"]["backbone"], **payload["batch_stats"]}
