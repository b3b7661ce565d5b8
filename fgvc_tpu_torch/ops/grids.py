"""Coordinate grids, Gaussian query heatmaps and top-k soft-argmax decoding
(fgvc_tpu/ops/grids.py).  Points are (x, y) in full-resolution pixels."""

from __future__ import annotations

import torch

from fgvc_tpu_torch.ops.topk import top_k, topk_segmented


def coords_grid(height: int, width: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """(height, width, 2) pixel coordinates, channel 0 = x, channel 1 = y
    (the reference's channel order, channels last)."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)


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

    The positions picked where activations tie at the k-th value are
    fgvc_tpu's: lax.top_k's for rows of up to 4096 pixels, topk_segmented's
    for longer rows of a 2-D stack (the bilinear upsample of a coarse grid
    leaves flat plateaus, so such ties are common past stride 2)."""
    width = heatmaps.shape[-1]
    flat = heatmaps.reshape(*heatmaps.shape[:-2], -1)
    if flat.shape[-1] > 4096 and flat.ndim == 2:
        vals, idx = topk_segmented(flat, topk, seg=512)
    else:
        vals, idx = top_k(flat, topk)
    w = vals / (torch.sum(vals, dim=-1, keepdim=True) + 1e-9)
    xs = (idx % width).to(flat.dtype)
    ys = torch.div(idx, width, rounding_mode="floor").to(flat.dtype)
    coord = torch.stack([torch.sum(xs * w, dim=-1), torch.sum(ys * w, dim=-1)], dim=-1)
    empty = torch.sum(flat, dim=-1, keepdim=True) == 0
    return torch.where(empty, -1.0, coord)
