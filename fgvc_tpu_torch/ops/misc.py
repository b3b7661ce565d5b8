"""Positional embeddings and the resizes of the zoo encoders
(fgvc_tpu/ops/misc.py, jax.image.resize).

* ``sincos_embedding_1d`` / ``sincos_embedding_2d``: the fixed sine/cosine
  positions of the dense-feature ViT.
* ``resize_bicubic``: jax.image.resize(..., 'bicubic') of the learned
  position grids (DINO, ResNet18Pos).  That is Keys' cubic with a = -0.5,
  its taps outside the image dropped and the rest renormalised, widened by
  the scale where it shrinks an axis.  F.interpolate's plain 'bicubic'
  (a = -0.75, edge taps clamped, no widening) is another function;
  ``antialias=True`` selects the one JAX computes, going up and down.
* ``resize_bilinear``: jax.image.resize(..., 'bilinear') (the tracker's
  decode and its keypoint maps, HRNet's fusion), by its per-axis weight
  matrices (``bilinear_weights``; antialiased where an axis shrinks).  Past
  the last input centre a weight row holds one tap of weight 1, so the
  bottom and right borders are exact copies of the last row and column, as
  in JAX; F.interpolate computes them as l0 * x + l1 * x, which can be an
  ulp off, and a decode's top-k over a plateau of such values picks other
  pixels than JAX's over exact ties.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F


def sincos_embedding_1d(dim: int, positions: torch.Tensor) -> torch.Tensor:
    """(..., dim) sine/cosine embedding of float positions: sines of the
    dim/2 frequencies 10000^(-2i/dim), then their cosines."""
    if dim % 2:
        raise ValueError(f"dim must be even, got {dim}")
    omega = torch.arange(dim // 2, dtype=torch.float32, device=positions.device) / (dim / 2.0)
    omega = 1.0 / (10000.0 ** omega)
    out = positions[..., None].to(torch.float32) * omega
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def sincos_embedding_2d(dim: int, height: int, width: int,
                        device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(H, W, dim) grid embedding: the first half embeds x, the second y."""
    if dim % 4:
        raise ValueError(f"dim must be a multiple of 4, got {dim}")
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                            torch.arange(width, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.cat([sincos_embedding_1d(dim // 2, gx), sincos_embedding_1d(dim // 2, gy)],
                     dim=-1)


def resize_bicubic(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(N, C, h, w) -> (N, C, H, W) as jax.image.resize(..., 'bicubic') on
    the spatial axes (identity at the same size)."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bicubic", align_corners=False,
                         antialias=True)


@functools.lru_cache(maxsize=64)
def bilinear_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) float32 weights of jax.image.resize(..., 'bilinear')
    along one axis: the triangle kernel at each output's half-pixel centre
    (widened by n_in / n_out where the axis shrinks: its antialiasing),
    normalised over the taps inside the input; the same weights as
    jit-compiled jax.image.resize to float32 rounding.  Cached per device:
    a copy from the host on every decode would make the host wait for the
    card's queue each frame."""
    # the sample positions as XLA computes them: (i + 0.5) * inv_scale - 0.5
    # in one fused multiply-add (one rounding), inv_scale a float32
    inv_scale = float(torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32))
    sample = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * inv_scale - 0.5).float()
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    if inv_scale > 1.0:
        dist = dist / inv_scale
    w = torch.clamp_min(1.0 - dist, 0.0)
    total = w.sum(0, keepdim=True)
    return (w / torch.where(total != 0, total, torch.ones_like(total))).to(device)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w) -> (..., H, W) as jax.image.resize(..., 'bilinear') on the
    last two axes."""
    wy = bilinear_weights(x.shape[-2], int(hw[0]), x.device)
    wx = bilinear_weights(x.shape[-1], int(hw[1]), x.device)
    return torch.einsum("...hw,hH,wW->...HW", x, wy, wx)
