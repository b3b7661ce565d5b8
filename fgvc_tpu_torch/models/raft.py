"""RAFT optical flow and the flow-chaining point tracker built on it
(fgvc_tpu/models/raft.py): the reference's flow-based tracking baseline.

All-pairs correlation, a 4-level average-pooled pyramid sampled in a radius-4
window, a separable ConvGRU refining the flow for `iters` steps, convex-mask
8x upsampling.  The point tracker computes forward and backward flows of
every frame pair and chains them through time from each query point; a point
is visible where it lies inside the frame.

The modules are NCHW and carry the official princeton-vl names (``fnet``,
``cnet``, ``update_block.encoder.convc1``, ``update_block.gru.convz1``,
``update_block.mask.2``, ...), so an official state dict loads into them
(models/weights.py load_raft_pth).  Where fgvc_tpu differs from the official
RAFT, the port follows fgvc_tpu, its reference:

* the instance norm is flax's GroupNorm(group_size=1): epsilon 1e-6 and the
  variance as E[x^2] - E[x]^2 (torch's InstanceNorm2d uses 1e-5);
* ``convex_upsample`` reads the mask head's 576 channels as (8, 8, 9), where
  the official RAFT reads (9, 8, 8);
* frames are scaled as x / 127.5 - 1.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fgvc_tpu_torch.device import set_matmul_precision
from fgvc_tpu_torch.ops.warp import bilinear_sample

HIDDEN = 128        # GRU state channels; the context encoder's other 128 are its input
ENCODER_CHUNK = 16  # frames per encoder call in RaftTracker
# frame pairs per refinement call in RaftTracker: at 32, cuDNN runs the motion
# encoder's 3x3 convolution to 126 channels as an FFT convolution, several
# times slower than 4 calls of 8
PAIR_CHUNK = 8


class InstanceNorm(nn.Module):
    """flax GroupNorm(group_size=1) with its identity scale and bias: per
    sample and channel over (H, W), epsilon 1e-6, variance E[x^2] - E[x]^2
    clipped at 0.  No parameters, as torch's InstanceNorm2d(affine=False)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean((2, 3), keepdim=True)
        var = ((x * x).mean((2, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * torch.rsqrt(var + 1e-6)


def make_norm(norm: str, channels: int) -> nn.Module:
    """'instance' (flax GroupNorm), 'batch' (eval-mode, running statistics;
    flax's epsilon 1e-5) or 'none'."""
    if norm == "instance":
        return InstanceNorm()
    if norm == "batch":
        return nn.BatchNorm2d(channels, eps=1e-5)
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"norm must be 'instance', 'batch' or 'none', got {norm!r}")


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1 = make_norm(norm, cout)
        self.norm2 = make_norm(norm, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride),
                                            make_norm(norm, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """RAFT's feature and context encoder: stride 8, `out_dim` channels."""

    def __init__(self, out_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm, 64)
        cin = 64
        for i, (cout, stride) in enumerate(((64, 1), (96, 2), (128, 2)), start=1):
            setattr(self, f"layer{i}", nn.Sequential(ResidualBlock(cin, cout, norm, stride),
                                                     ResidualBlock(cout, cout, norm, 1)))
            cin = cout
        self.conv2 = nn.Conv2d(128, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


def correlation_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int = 4) -> List[torch.Tensor]:
    """All-pairs correlation of (N, C, H, W) features over sqrt(C), then
    floor 2x2 average pools: `levels` maps of (N*H*W, H/2^l, W/2^l, 1), one
    per pixel of f1.  Where a level is already 1 x 1 it is repeated, so the
    motion encoder's channel count stays levels * (2r+1)^2 at any size."""
    N, C, H, W = f1.shape
    corr = torch.matmul(f1.reshape(N, C, H * W).transpose(1, 2), f2.reshape(N, C, H * W))
    cur = (corr / float(np.sqrt(np.float32(C)))).reshape(N * H * W, 1, H, W)
    pyramid = [cur]
    for _ in range(levels - 1):
        if cur.shape[2] // 2 >= 1 and cur.shape[3] // 2 >= 1:
            cur = F.avg_pool2d(cur, 2, stride=2)
        pyramid.append(cur)
    return [p.permute(0, 2, 3, 1) for p in pyramid]


def window_offsets(radius: int, n: int, device) -> torch.Tensor:
    """(n^2, 2) offsets added to (x, y): the reference's
    stack(meshgrid(dy, dx)), so the x offset varies along the SLOW window
    axis (corr_lookup.py:52, kept by fgvc_tpu)."""
    d = torch.linspace(-float(radius), float(radius), n, device=device)
    slow, fast = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([slow, fast], dim=-1).reshape(-1, 2)


def lookup_corr(pyramid: List[torch.Tensor], coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Sample each pyramid level in a (2r+1)^2 window around coords / 2^l
    (bilinear, zero padding).  coords: (N, H, W, 2) flow targets in stride-8
    pixels.  Returns (N, levels * (2r+1)^2, H, W), level-major.

    The levels are zero-padded to level 0's size and sampled in one
    bilinear_sample call (a few dozen kernels, not that many per level): a
    corner past a level's edge reads a padded zero, which is what the
    zero-padded sample of that level adds."""
    N, H, W, _ = coords.shape
    L = len(pyramid)
    h0, w0 = pyramid[0].shape[1:3]
    maps = torch.stack([F.pad(p, (0, 0, 0, w0 - p.shape[2], 0, h0 - p.shape[1]))
                        for p in pyramid], dim=1).reshape(-1, h0, w0, 1)
    centres = torch.stack([coords / (2.0**lvl) for lvl in range(L)], dim=3)
    offsets = window_offsets(radius, 2 * radius + 1, coords.device)
    pts = centres.reshape(N * H * W * L, 1, 2) + offsets[None]
    return bilinear_sample(maps, pts).reshape(N, H, W, -1).permute(0, 3, 1, 2)


def lookup_heat(heats: torch.Tensor, coords: torch.Tensor, radius: int = 4,
                interval: int = 1) -> torch.Tensor:
    """The HeatLookup operator: (T, P, H, W) per-point heatmaps sampled in an
    n x n window around (T, P, 2) (x, y) centres, n = 2 * (radius //
    interval) + 1, with the transposed-window quirk of `lookup_corr`.
    Returns (T, P, n^2)."""
    T, P, H, W = heats.shape
    n = 2 * (radius // interval) + 1
    offsets = window_offsets(radius, n, heats.device)
    pts = coords.reshape(T * P, 1, 2) + offsets[None]
    return bilinear_sample(heats.reshape(T * P, H, W, 1), pts)[..., 0].reshape(T, P, n * n)


class MotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(192 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], dim=1))), flow], dim=1)


class SepConvGRU(nn.Module):
    """A ConvGRU over (1, 5) convolutions, then one over (5, 1)."""

    def __init__(self, hidden: int = HIDDEN, inputs: int = 256):
        super().__init__()
        for i, (k, p) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))), start=1):
            for gate in "zrq":
                setattr(self, f"conv{gate}{i}", nn.Conv2d(hidden + inputs, hidden, k, padding=p))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for i in (1, 2):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(HIDDEN, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(h)))


class UpdateBlock(nn.Module):
    """The official BasicUpdateBlock: motion encoder, GRU, flow head and the
    convex-upsampling mask head (`mask`, scaled by 0.25 where it is used)."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.encoder = MotionEncoder(corr_planes)
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(nn.Conv2d(HIDDEN, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, 2, H, W) flow -> (N, 2, 8H, 8W): each output pixel a softmax-
    weighted combination of the 3x3 neighbourhood of 8 * flow.  The mask's
    576 channels are read as (8, 8, 9) as fgvc_tpu reads them (the official
    RAFT reads (9, 8, 8))."""
    N, _, H, W = flow.shape
    m = torch.softmax(mask.reshape(N, 8, 8, 9, H, W), dim=3)
    neigh = F.unfold(flow * 8.0, 3, padding=1).reshape(N, 2, 9, H, W)
    up = torch.einsum("nabkhw,nckhw->nchawb", m, neigh)
    return up.reshape(N, 2, 8 * H, 8 * W)


def coords_grid(N: int, H: int, W: int, device) -> torch.Tensor:
    """(N, H, W, 2) pixel (x, y) of every position."""
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1).expand(N, H, W, 2)


class RAFT(nn.Module):
    """RAFT on batches of image pairs (N, 3, H, W), already scaled to [-1, 1].
    `cnet_norm` is 'batch' for official weights and 'none' for seeded
    ones, as in fgvc_tpu."""

    def __init__(self, iters: int = 12, corr_levels: int = 4, corr_radius: int = 4,
                 cnet_norm: str = "none"):
        super().__init__()
        self.iters, self.corr_levels, self.corr_radius = iters, corr_levels, corr_radius
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(256, cnet_norm)
        self.update_block = UpdateBlock(corr_levels * (2 * corr_radius + 1) ** 2)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> List[torch.Tensor]:
        """Every iteration's upsampled flow (N, 2, 8h, 8w), the last final."""
        return self.refine(self.fnet(image1), self.fnet(image2), self.cnet(image1))

    def refine(self, f1: torch.Tensor, f2: torch.Tensor, ctx: torch.Tensor,
               iters: Optional[int] = None, last_only: bool = False) -> List[torch.Tensor]:
        """The iterations from the encoders' outputs: features of both
        images and the context of the first.  `last_only` computes the mask
        head and the upsample at the last iteration only (the same final
        flow)."""
        iters = self.iters if iters is None else iters
        ub = self.update_block
        h = torch.tanh(ctx[:, :HIDDEN])
        inp = F.relu(ctx[:, HIDDEN:])
        pyramid = correlation_pyramid(f1, f2, self.corr_levels)
        N, _, H, W = f1.shape
        coords0 = coords_grid(N, H, W, f1.device)
        coords1 = coords0
        preds = []
        for i in range(iters):
            coords1 = coords1.detach()
            corr = lookup_corr(pyramid, coords1, self.corr_radius)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            h = ub.gru(h, torch.cat([inp, ub.encoder(flow, corr)], dim=1))
            coords1 = coords1 + ub.flow_head(h).permute(0, 2, 3, 1)
            if not last_only or i == iters - 1:
                mask = ub.mask(h) * 0.25
                preds.append(convex_upsample((coords1 - coords0).permute(0, 3, 1, 2), mask))
        return preds


def sequence_loss(preds: List[torch.Tensor], flow_gt: torch.Tensor, valid: torch.Tensor,
                  gamma: float = 0.8, max_flow: float = 400.0) -> torch.Tensor:
    """gamma-weighted L1 over the refinement sequence: preds and flow_gt (N,
    2, H, W), valid (N, H, W) bool; pixels with |flow_gt| >= max_flow are
    left out."""
    valid = valid & (torch.sqrt(torch.sum(flow_gt**2, dim=1)) < max_flow)
    n = len(preds)
    total = 0.0
    for i, p in enumerate(preds):
        l1 = torch.abs(p - flow_gt).mean(dim=1)
        total = total + gamma ** (n - i - 1) * torch.sum(l1 * valid) / valid.sum().clamp_min(1)
    return total


# --------------------------------------------------------------------- #
# the flow-chaining point tracker
# --------------------------------------------------------------------- #
def _sample_flow(flow: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Bilinear flow (H, W, 2) at (n, 2) points clipped into the frame, in
    fgvc_tpu's float32 arithmetic and corner order."""
    H, W = flow.shape[:2]
    x = np.clip(pts[:, 0], 0, W - 1)
    y = np.clip(pts[:, 1], 0, H - 1)
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    x1, y1 = np.minimum(x0 + 1, W - 1), np.minimum(y0 + 1, H - 1)
    wx = (x - x0.astype(np.float32))[:, None]
    wy = (y - y0.astype(np.float32))[:, None]
    return (flow[y0, x0] * (1 - wx) * (1 - wy) + flow[y0, x1] * wx * (1 - wy)
            + flow[y1, x0] * (1 - wx) * wy + flow[y1, x1] * wx * wy)


def chain_flows_track(
    flows_fwd: np.ndarray,     # (T-1, H, W, 2) frame t -> t+1
    flows_bwd: np.ndarray,     # (T-1, H, W, 2) frame t+1 -> t
    query_points: np.ndarray,  # (P, 3) (t, x, y)
) -> Tuple[np.ndarray, np.ndarray]:
    """Chain the flows from each query point: forward from its query frame
    through the forward flows, backward before it through the backward
    flows.  Visible = inside [0, W-1] x [0, H-1].  Returns (T, P, 2)
    trajectories and (T, P) visibilities.  fgvc_tpu's per-point loop,
    vectorised over the points with the same float32 arithmetic."""
    T = flows_fwd.shape[0] + 1
    H, W = flows_fwd.shape[1:3]
    P = query_points.shape[0]
    qt = query_points[:, 0].astype(np.int64)
    start = np.asarray(query_points[:, 1:], np.float32)
    traj = np.zeros((T, P, 2), np.float32)
    vis = np.zeros((T, P), bool)
    traj[qt, np.arange(P)] = start
    vis[qt, np.arange(P)] = True

    def step(flow, cur, sel, t_to):
        cur[sel] = cur[sel] + _sample_flow(flow, cur[sel])
        traj[t_to, sel] = cur[sel]
        vis[t_to, sel] = ((0 <= cur[sel, 0]) & (cur[sel, 0] <= W - 1)
                          & (0 <= cur[sel, 1]) & (cur[sel, 1] <= H - 1))

    cur = start.copy()
    for t in range(T - 1):           # forward: points queried at or before t
        step(flows_fwd[t], cur, np.nonzero(qt <= t)[0], t + 1)
    cur = start.copy()
    for t in range(T - 1, 0, -1):    # backward: points queried at or after t
        step(flows_bwd[t - 1], cur, np.nonzero(qt >= t)[0], t - 1)
    return traj, vis


class RaftTracker:
    """RAFT as a point tracker (the reference's RAFT baseline protocol):
    forward and backward flows of every frame pair, chained from each query
    point, visibility in bounds.  Scored by the harness's eval_tapvid like
    the label-propagation Tracker.

    Each frame runs through the feature and context encoders once (16
    frames a call), and the pairs' refinements run 8 pairs a call, where
    fgvc_tpu runs RAFT once per pair; each flow is the same function of its
    two frames."""

    def __init__(self, model: RAFT, device: torch.device, iters: int = 12):
        set_matmul_precision("highest")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.iters = iters

    @torch.no_grad()
    def flows(self, video: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, H, W, 3) uint8 RGB -> forward and backward flows, each (T-1,
        2, H, W) on the device."""
        T, H, W = video.shape[:3]
        if H % 8 or W % 8:
            raise ValueError(f"RAFT needs frames whose sides are multiples of 8, got {H}x{W}")
        x = torch.from_numpy(np.ascontiguousarray(video)).to(self.device)
        frames = x.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
        chunks = [frames[i : i + ENCODER_CHUNK] for i in range(0, T, ENCODER_CHUNK)]
        fmaps = torch.cat([self.model.fnet(c) for c in chunks])
        ctx = torch.cat([self.model.cnet(c) for c in chunks])
        # pair indices made on the device: indexing with host ones copies
        # them over, and such a copy waits for the card's queue
        idx = torch.arange(T, device=self.device)
        src = torch.cat([idx[:-1], idx[1:]])
        dst = torch.cat([idx[1:], idx[:-1]])
        out = []
        for i in range(0, len(src), PAIR_CHUNK):
            s, d = src[i : i + PAIR_CHUNK], dst[i : i + PAIR_CHUNK]
            out += self.model.refine(fmaps[s], fmaps[d], ctx[s], self.iters, last_only=True)
        flows = torch.cat(out)
        return flows[: T - 1], flows[T - 1 :]

    def track_points(self, video: np.ndarray, query_points: np.ndarray):
        """video (T, H, W, 3) uint8; query_points (P, 3) (t, x, y).  Returns
        {"trajectories": (T, P, 2), "visibilities": (T, P)}."""
        fwd, bwd = (f.permute(0, 2, 3, 1).cpu().numpy() for f in self.flows(video))
        traj, vis = chain_flows_track(fwd, bwd, np.asarray(query_points, np.float32))
        return {"trajectories": traj, "visibilities": vis}
