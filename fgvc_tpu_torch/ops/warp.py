"""Bilinear sampling, backward warping and the forward-backward consistency
mask of the training recipe (fgvc_tpu/ops/warp.py).  Channels-last, with a
leading batch axis.

`forward_backward_consistency` keeps the reference's literal formula, its
``flow_fw * 2`` term included, and its Warp module's mixed align-corners
sampling with the hard validity mask (`backward_warp_reference_quirk`): the
released models were trained with both.
"""

from __future__ import annotations

import torch


def _grid(B: int, H: int, W: int, device) -> tuple:
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return gx.expand(B, H, W), gy.expand(B, H, W)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample img (B, H, W, C) at float pixel coords (B, ..., 2) (x, y);
    zero padding: a corner outside [0, W-1] x [0, H-1] adds nothing, so
    samples fade to 0 across the border (grid_sample with
    align_corners=True and padding_mode='zeros' at pixel coordinates)."""
    B, H, W, C = img.shape
    flat = img.reshape(B, H * W, C)
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    out = 0
    for ix, iy, w in ((x0, y0, wx0 * wy0), (x0 + 1, y0, wx1 * wy0),
                      (x0, y0 + 1, wx0 * wy1), (x0 + 1, y0 + 1, wx1 * wy1)):
        inside = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = (iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long()).reshape(B, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        vals = vals.reshape(*x.shape, C) * inside[..., None]
        out = out + vals * w[..., None]
    return out


def backward_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W, C) by flow (B, H, W, 2): out[p] = img[p + flow[p]]."""
    B, H, W, _ = flow.shape
    gx, gy = _grid(B, H, W, flow.device)
    return bilinear_sample(img, torch.stack([gx + flow[..., 0], gy + flow[..., 1]], -1))


def backward_warp_reference_quirk(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The reference Warp module's sampling: coordinates normalised with the
    align_corners=True formula but sampled with align_corners=False, so the
    position is p * W / (W - 1) - 0.5 per axis; outputs whose bilinear
    support leaves the image are zeroed (grid_sample(ones) > 0.9999)."""
    B, H, W, _ = flow.shape
    gx, gy = _grid(B, H, W, flow.device)
    tx = (gx + flow[..., 0]) * (W / (W - 1)) - 0.5
    ty = (gy + flow[..., 1]) * (H / (H - 1)) - 0.5
    coords = torch.stack([tx, ty], dim=-1)
    out = bilinear_sample(img, coords)
    ones = torch.ones((B, H, W, 1), dtype=img.dtype, device=img.device)
    valid = bilinear_sample(ones, coords) > 0.9999
    return out * valid.to(img.dtype)


def forward_backward_consistency(flow_fw: torch.Tensor, flow_bw: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float mask, 1 = consistent (non-occluded):
    |f_fw + w|^2 < (f_fw * 2 + w^2) * 0.01 + 0.5, summed over x and y, with
    w = flow_bw warped by flow_fw."""
    warped_bw = backward_warp_reference_quirk(flow_bw, flow_fw)
    sq_diff = torch.sum((flow_fw + warped_bw) ** 2, dim=-1)
    sum_sq = torch.sum(flow_fw * 2 + warped_bw ** 2, dim=-1)
    return (sq_diff < sum_sq * 0.01 + 0.5).to(flow_fw.dtype)
