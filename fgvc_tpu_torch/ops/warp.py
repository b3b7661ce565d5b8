"""Bilinear sampling, backward warping, the occlusion masks of the training
recipe, and the flow composition of the flow-guided tracker
(fgvc_tpu/ops/warp.py).  Channels-last, with a leading batch axis.

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


def forward_backward_absdiff(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                             diff: float = 1.5) -> torch.Tensor:
    """(B, H, W) mask: |f_fw + w| < diff, w = flow_bw warped by flow_fw with
    the reference Warp's sampling (fb_abs mode)."""
    warped_bw = backward_warp_reference_quirk(flow_bw, flow_fw)
    sq = torch.sum((flow_fw + warped_bw) ** 2, dim=-1)
    return (torch.sqrt(sq) < diff).to(flow_fw.dtype)


def compute_range_map(flow: torch.Tensor) -> torch.Tensor:
    """(B, H, W) soft count of the flow targets landing on each pixel: each
    pixel scatters bilinear weights to the four neighbours of p + flow[p]
    (range_map mode: a pixel nobody flows into is likely occluded).  A
    scatter-add: on the card its sum order, and so its last bits, is not
    deterministic."""
    B, H, W, _ = flow.shape
    gx, gy = _grid(B, H, W, flow.device)
    tx = (gx + flow[..., 0]).reshape(B, -1)
    ty = (gy + flow[..., 1]).reshape(B, -1)
    x0, y0 = torch.floor(tx), torch.floor(ty)
    counts = torch.zeros((B, H * W), dtype=torch.float32, device=flow.device)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        w = (1 - torch.abs(tx - xi)) * (1 - torch.abs(ty - yi))
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        counts.scatter_add_(1, idx, torch.where(inside, w, 0.0))
    return counts.reshape(B, H, W)


def occlusion_masks(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                    mode: str = "consistency", **kw):
    """dict(occ_fw, occ_bw) of (B, H, W) masks, 1 = not occluded, by
    'consistency', 'fb_abs' or 'range_map' (target count >= 1)."""
    if mode == "consistency":
        fw = forward_backward_consistency(flow_fw, flow_bw)
        bw = forward_backward_consistency(flow_bw, flow_fw)
    elif mode == "fb_abs":
        fw = forward_backward_absdiff(flow_fw, flow_bw, **kw)
        bw = forward_backward_absdiff(flow_bw, flow_fw, **kw)
    elif mode == "range_map":
        fw = (compute_range_map(flow_bw) >= 1.0).to(flow_fw.dtype)
        bw = (compute_range_map(flow_fw) >= 1.0).to(flow_fw.dtype)
    else:
        raise ValueError(f"unknown occlusion mode {mode}")
    return {"occ_fw": fw, "occ_bw": bw}


def compose_flows(f_ab: torch.Tensor, g_bc: torch.Tensor) -> torch.Tensor:
    """(B, h, w, 2) backward flows a -> b and b -> c composed into a -> c:
    f_ab(x) + g_bc(x + f_ab(x)), g_bc bilinearly sampled (0 outside)."""
    B, h, w, _ = f_ab.shape
    gx, gy = _grid(B, h, w, f_ab.device)
    tgt = torch.stack([gx + f_ab[..., 0], gy + f_ab[..., 1]], dim=-1)
    return f_ab + bilinear_sample(g_bc, tgt)


def chain_window_flows(adj: torch.Tensor, precede_frames: int) -> torch.Tensor:
    """Adjacent backward flows (T-1, h, w, 2), adj[i] = frame i+1 -> i, ->
    (T-1, K+1, h, w, 2) key-window flows: row t-1 holds query frame t's flows
    to [frame 0, t-K, ..., t-1], the tracker's key slot order, by
    W_t[1] = adj[t-1], W_t[k] = adj[t-1] o W_{t-1}[k-1] and
    C_t = adj[t-1] o C_{t-1} (C_0 = 0).  Pre-video slots hold meaningless
    flows that key_valid masks."""
    K = precede_frames
    if K < 1:
        raise ValueError(f"chain_window_flows needs precede_frames >= 1, got {K}")
    h, w = adj.shape[1:3]
    warr = adj.new_zeros((K, h, w, 2))   # warr[j]: flow t-1 -> (t-1)-(j+1)
    c0 = adj.new_zeros((1, h, w, 2))     # flow t-1 -> 0
    outs = []
    for f in adj:
        f = f[None]
        warr = torch.cat([f, compose_flows(f.expand(K - 1, h, w, 2), warr[:-1])]) if K > 1 else f
        c0 = compose_flows(f, c0)
        outs.append(torch.cat([c0, warr.flip(0)]))
    return torch.stack(outs)
