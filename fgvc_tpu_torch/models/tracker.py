"""Label-propagation point tracker (fgvc_tpu/models/tracker.py, main path).

TAP-Vid point tracking as the JAX Tracker runs it with attention_impl
'pallas': uint8 frames -> Lab -> ResNet features (16-frame chunks, on the
device) -> one normalised, halo-padded key bank per video -> for each group
of points sharing a query frame, a loop over the following frames, each
attending over frame 0 of the group plus the `precede_frames` preceding
frames through the top-k attention kernel -> bilinear upsample to the input
size and top-5 soft-argmax.

Differences from the JAX Tracker that leave the results unchanged: frames
and points are not padded to buckets (PyTorch runs eagerly; bucketing exists
for jit's static shapes), the bank is built once per video instead of once
per group, and the scan is a Python loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fgvc_tpu_torch.config import TestConfig, check_ported
from fgvc_tpu_torch.device import set_matmul_precision
from fgvc_tpu_torch.ops.color import preprocess_rgb_to_lab_normalized
from fgvc_tpu_torch.ops.cuda.topk_attention import (
    bank_geometry,
    pad_key_bank,
    topk_attention_banked,
)
from fgvc_tpu_torch.ops.grids import draw_gaussian_maps, soft_argmax_topk

EXTRACT_CHUNK = 16  # frames per backbone call


class Tracker:
    """Feature extraction + top-k attention label propagation.

    Args:
      backbone: module mapping (N, 3, H, W) normalised Lab to (N, C, h, w).
      cfg: propagation settings (only the main path's are ported).
      device: where the backbone, the bank and the kernels run.
    """

    def __init__(self, backbone: nn.Module, cfg: TestConfig, device: torch.device):
        check_ported(cfg)
        set_matmul_precision(cfg.matmul_precision)
        self.cfg = cfg
        self.device = torch.device(device)
        self.backbone = backbone.to(self.device).eval()
        self.radius = cfg.neighbor_range // 2
        # the kernel's query tile (the Pallas kernel capped it at 16 too)
        self.tile = min(cfg.tile, 16)

    # ------------------------------------------------------------------ #
    # features and bank
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def extract_features(self, video: np.ndarray) -> torch.Tensor:
        """(T, H, W, 3) uint8 RGB -> (T, h, w, C) float32 features on the
        device; preprocessing runs on the device too."""
        if video.dtype != np.uint8 or video.ndim != 4:
            raise ValueError(
                f"expected (T, H, W, 3) uint8 frames, got {video.dtype} {video.shape}"
            )
        parts = []
        for i in range(0, video.shape[0], EXTRACT_CHUNK):
            x = torch.from_numpy(np.ascontiguousarray(video[i : i + EXTRACT_CHUNK]))
            x = preprocess_rgb_to_lab_normalized(x.to(self.device))
            f = self.backbone(x.permute(0, 3, 1, 2).contiguous())
            parts.append(f.permute(0, 2, 3, 1))
        return torch.cat(parts).contiguous()

    def build_bank(self, feats: torch.Tensor) -> torch.Tensor:
        return pad_key_bank(
            feats, float(self.radius), tile=self.tile, normalize=self.cfg.with_norm
        )

    # ------------------------------------------------------------------ #
    # propagation
    # ------------------------------------------------------------------ #
    def window_indices(self, t: int, L: int) -> Tuple[List[int], List[bool]]:
        """Key slots of group frame t: frame 0 first, then the
        `precede_frames` before t (clipped; pre-group slots invalid)."""
        P = self.cfg.precede_frames
        win = [t - P + i for i in range(P)]
        idx = [0] + [min(max(w, 0), L - 1) for w in win]
        valid = [self.cfg.with_first] + [w >= 0 for w in win]
        return idx, valid

    def decode(self, logits: torch.Tensor, full_hw: Tuple[int, int]) -> torch.Tensor:
        """(h, w, P) logits -> (P, 2): (x, y) at full resolution by bilinear
        upsampling and top-5 soft-argmax.  (The JAX decode's third column,
        the peak that visibility_mode 'heatmap' reads, comes with that
        mode.)"""
        up = F.interpolate(
            logits.permute(2, 0, 1)[None], size=full_hw, mode="bilinear",
            align_corners=False,
        )[0]
        return soft_argmax_topk(up, topk=5)

    def propagate(
        self,
        bank: torch.Tensor,       # padded bank of the whole video
        t0: int,                  # query frame of the group
        length: int,              # frames t0 .. t0 + length - 1
        init_maps: torch.Tensor,  # (P, h, w) value maps at feature resolution
        full_hw: Tuple[int, int],
    ) -> torch.Tensor:
        """(length, P, 2) decoded points; row 0 decodes init_maps."""
        cfg = self.cfg
        h, w = init_maps.shape[1:]
        halo, Hp, Wp, _, _ = bank_geometry(h, w, self.radius, self.tile)
        first = init_maps.permute(1, 2, 0).contiguous()   # (h, w, P)
        buf = [first] * cfg.precede_frames                # value ring buffer
        rows = [self.decode(first, full_hw)]
        for t in range(1, length):
            idx, valid = self.window_indices(t, length)
            qpad = bank[t0 + t, halo : halo + Hp, halo : halo + Wp].contiguous()
            seg = topk_attention_banked(
                qpad, bank, torch.stack([first, *buf]),
                frame_idx=[t0 + i for i in idx], key_valid=valid, H=h, W=w,
                radius=float(self.radius), temperature=cfg.temperature,
                topk=cfg.topk, tile=self.tile,
            )
            buf = buf[1:] + [seg]
            rows.append(self.decode(seg, full_hw))
        return torch.stack(rows)

    def track_group(
        self, bank: torch.Tensor, t0: int, length: int, pts: torch.Tensor,
        feat_hw: Tuple[int, int], full_hw: Tuple[int, int],
    ) -> torch.Tensor:
        """One query-frame group: gaussian maps, propagation, decode.  Row 0
        decodes the full-resolution gaussian."""
        H, W = full_hw
        stride = H // feat_hw[0]
        init_maps = draw_gaussian_maps(pts, H, W, sigma=self.cfg.sigma, stride=stride)
        rows = self.propagate(bank, t0, length, init_maps, full_hw)
        full_maps = draw_gaussian_maps(pts, H, W, sigma=self.cfg.sigma, stride=1)
        return torch.cat([soft_argmax_topk(full_maps, topk=5)[None], rows[1:]])

    # ------------------------------------------------------------------ #
    # TAP-Vid protocol
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def track_points_dispatch(
        self,
        video: np.ndarray,          # (T, H, W, 3) uint8 RGB
        query_points: np.ndarray,   # (P, 3) (t, x, y) in input pixels
        feats: Optional[torch.Tensor] = None,
    ) -> Dict:
        """Queue the whole forward test on the device; `track_points_collect`
        reads the results, once per group."""
        T, H, W, _ = video.shape
        if feats is None:
            feats = self.extract_features(video)
        bank = self.build_bank(feats)
        qt = query_points[:, 0].astype(np.int64)
        pending = []
        for t in np.unique(qt):
            sel = np.nonzero(qt == t)[0]
            pts = torch.from_numpy(
                np.ascontiguousarray(query_points[sel, 1:], dtype=np.float32)
            ).to(self.device)
            rows = self.track_group(
                bank, int(t), T - int(t), pts, tuple(feats.shape[1:3]), (H, W)
            )
            pending.append((int(t), sel, rows))
        return {"pending": pending, "T": T, "P": query_points.shape[0]}

    def track_points_collect(self, disp: Dict) -> Dict[str, np.ndarray]:
        """Trajectories (T, P, 2); frames before a point's query frame stay
        0.  Visibilities are all False (visibility_mode 'none')."""
        T, P = disp["T"], disp["P"]
        traj = np.zeros((T, P, 2), dtype=np.float32)
        for t, sel, rows in disp["pending"]:
            traj[t:, sel] = rows.cpu().numpy()
        return {"trajectories": traj, "visibilities": np.zeros((T, P), dtype=bool)}

    def track_points(
        self, video: np.ndarray, query_points: np.ndarray,
        feats: Optional[torch.Tensor] = None,
    ) -> Dict[str, np.ndarray]:
        return self.track_points_collect(
            self.track_points_dispatch(video, query_points, feats=feats)
        )
