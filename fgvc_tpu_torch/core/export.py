"""The per-frame serving step as a torch.export program (fgvc_tpu/core/export.py).

fgvc_tpu lowers its jitted step to StableHLO with ``jax.export``; the port
exports the same step with ``torch.export`` into one ``.pt2`` file (weights
embedded) that a serving process loads and calls without the model's Python
code:

    (uint8 RGB frame, key bank, value bank) ->
        Lab preprocessing -> ResNet-18-d1 features ->
        top-k attention against the bank (circle window, every key slot
        valid) -> propagated (h, w, Cv) maps.

With attention_impl 'pallas' (the port's default) the attention is K2, the
unbanked entry of the top-k attention kernel, through its registered
operator ``fgvc_tpu_torch::topk_attention`` (ops/cuda/topk_attention.py):
the program holds it as one node, and a process that loads the program
imports that module first, which registers it.  fgvc_tpu's default 'tiled',
and 'dense' and 'c2f', export as the plain PyTorch of the Tracker's
attention_step (models/tracker.py), traced into the program.

fgvc_tpu's ``platforms`` has no counterpart: a torch.export program holds
its weights as tensors on the device it was exported on, so the artifact
runs on that device (``device``; the CUDA card by default).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from fgvc_tpu_torch.config import TestConfig, check_ported
from fgvc_tpu_torch.device import resolve_device, set_matmul_precision
from fgvc_tpu_torch.models.resnet import init_random, resnet18_d1
from fgvc_tpu_torch.models.tracker import Tracker
from fgvc_tpu_torch.models.weights import load_weights
from fgvc_tpu_torch.ops.color import preprocess_fn
# importing topk_attention_op registers fgvc_tpu_torch::topk_attention
from fgvc_tpu_torch.ops.cuda.topk_attention import pallas_compute_dtype, topk_attention_op  # noqa: F401

FEATURE_CHANNELS = 256  # ResNet-18-d1's output channels
STRIDE = 2              # and its feature stride


class FlagshipStep(nn.Module):
    """forward(frame (H, W, 3) uint8, keys (P+1, h, w, 256), values (P+1,
    h, w, Cv) float32) -> (h, w, Cv) float32: the frame's features attend
    over the raw keys (normalised per call when cfg.with_norm) with the
    circle window, every key slot valid, and mix the values: through the
    operator for 'pallas' (with with_first_neighbor), else through the
    Tracker's attention_step, as fgvc_tpu's step calls _attention_step."""

    def __init__(self, cfg: TestConfig, backbone: nn.Module):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.backbone = backbone.eval()
        self.tracker = Tracker(backbone, cfg, next(backbone.parameters()).device)
        self.preprocess = preprocess_fn(cfg.preprocess)
        self.n_keys = cfg.precede_frames + 1
        self.compute_dtype = pallas_compute_dtype(cfg.matmul_precision)

    def forward(self, frame: torch.Tensor, keys: torch.Tensor, values: torch.Tensor):
        # contiguous before the backbone and the operator: torch.export keeps
        # a contiguous() only where the traced strides need it, and the
        # operator's norm sums in the order of contiguous rows
        cfg = self.cfg
        x = self.preprocess(frame[None])
        f = self.backbone(x.permute(0, 3, 1, 2).contiguous())
        query = f.permute(0, 2, 3, 1)[0].contiguous()
        if cfg.attention_impl != "pallas" or not cfg.with_first_neighbor:
            return self.tracker.attention_step(query, keys, values, [True] * self.n_keys,
                                               "circle")
        return torch.ops.fgvc_tpu_torch.topk_attention(
            query, keys, values, float(cfg.neighbor_range // 2), cfg.temperature, cfg.topk,
            cfg.with_norm, min(cfg.tile, 16), "circle", [True] * self.n_keys,
            self.compute_dtype,
        )


def make_flagship_step(
    cfg: TestConfig,
    model: nn.Module,
    input_size: Optional[Tuple[int, int]] = None,
    value_dim: int = 8,
    device: Optional[Union[str, torch.device]] = None,
):
    """(step, example_args) for the per-frame serving step over `model` (a
    ResNet-18-d1 with its weights), on `device` (the CUDA card unless named).
    The example arguments are fgvc_tpu's: numpy's default_rng(0) draws the
    frame, then the keys, then the values."""
    dev = resolve_device(device)
    set_matmul_precision(cfg.matmul_precision)
    step = FlagshipStep(cfg, model.to(dev))
    H, W = input_size or cfg.input_size
    h, w = H // STRIDE, W // STRIDE
    n = step.n_keys
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    keys = rng.standard_normal((n, h, w, FEATURE_CHANNELS)).astype(np.float32)
    values = rng.standard_normal((n, h, w, value_dim)).astype(np.float32)
    example_args = tuple(torch.from_numpy(a).to(dev) for a in (frame, keys, values))
    return step, example_args


def export_program(module: nn.Module, example_args: Sequence[torch.Tensor]):
    """torch.export.export of `module` at the shapes and dtypes of
    `example_args` (static, as fgvc_tpu's export_jit).  The program keeps
    no copy of the example arguments, so its file holds the weights only."""
    with torch.no_grad():
        exported = torch.export.export(module, tuple(example_args))
    exported.example_inputs = None
    return exported


def save_exported(exported, path: str) -> int:
    """Write the program to a .pt2 file; returns its size in bytes."""
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load_exported(path: str):
    """The ExportedProgram of a .pt2 file (``.module()`` calls it); the
    operator it holds is registered by this module's import."""
    return torch.export.load(path)


def export_flagship(
    cfg: Optional[TestConfig] = None,
    state: Optional[Dict[str, torch.Tensor]] = None,
    input_size: Optional[Tuple[int, int]] = None,
    value_dim: int = 8,
    device: Optional[Union[str, torch.device]] = None,
):
    """One call: (exported, step, example_args).  `state` is a ResNet-18-d1
    state dict in the port's names; None exports seeded random weights
    (init_random, seed 0), for plumbing."""
    cfg = cfg or TestConfig()
    model = resnet18_d1()
    if state is None:
        init_random(model, 0)
    else:
        load_weights(model, state)
    step, example_args = make_flagship_step(cfg, model, input_size=input_size,
                                            value_dim=value_dim, device=device)
    return export_program(step, example_args), step, example_args
