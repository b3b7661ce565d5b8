"""Gaussian query heatmaps and top-k soft-argmax decoding
(fgvc_tpu/ops/grids.py).  Points are (x, y) in full-resolution pixels."""

from __future__ import annotations

import torch


def draw_gaussian_maps(
    points_xy: torch.Tensor,   # (P, 2)
    height: int,
    width: int,
    sigma: float = 6.0,
    stride: int = 1,
) -> torch.Tensor:
    """(P, ceil(height / stride), ceil(width / stride)) gaussians drawn on
    the strided grid (grid coordinate = stride * index)."""
    h_out = -(-height // stride)
    w_out = -(-width // stride)
    dev, dt = points_xy.device, points_xy.dtype
    gy = (torch.arange(h_out, device=dev, dtype=dt) * stride)[:, None]
    gx = (torch.arange(w_out, device=dev, dtype=dt) * stride)[None, :]
    px = points_xy[:, 0][:, None, None]
    py = points_xy[:, 1][:, None, None]
    d2 = (gx[None] - px) ** 2 + (gy[None] - py) ** 2
    return torch.exp(-d2 / (2.0 * sigma**2))


def soft_argmax_topk(heatmaps: torch.Tensor, topk: int = 5) -> torch.Tensor:
    """(..., H, W) heatmaps -> (..., 2) (x, y): the weighted mean position of
    the top-k activations.  All-zero maps decode to (-1, -1).

    torch.topk is exact; where activations tie at the k-th value it may pick
    other positions than lax.top_k."""
    width = heatmaps.shape[-1]
    flat = heatmaps.reshape(*heatmaps.shape[:-2], -1)
    vals, idx = torch.topk(flat, topk, dim=-1)
    w = vals / (torch.sum(vals, dim=-1, keepdim=True) + 1e-9)
    xs = (idx % width).to(flat.dtype)
    ys = torch.div(idx, width, rounding_mode="floor").to(flat.dtype)
    coord = torch.stack([torch.sum(xs * w, dim=-1), torch.sum(ys * w, dim=-1)], dim=-1)
    empty = torch.sum(flat, dim=-1, keepdim=True) == 0
    return torch.where(empty, -1.0, coord)
