"""Label-propagation tracker (fgvc_tpu/models/tracker.py, attention_impl
'pallas').

Two protocols share one propagation loop:

* TAP-Vid point tracking: uint8 frames -> Lab -> ResNet features (16-frame
  chunks, on the device) -> one normalised, halo-padded key bank per video
  -> for each group of points sharing a query frame, a loop over the
  following frames, each attending over frame 0 of the group plus the
  `precede_frames` preceding frames through the banked top-k attention
  kernel (K1, circle window) -> bilinear upsample to the input size and
  top-5 soft-argmax.
* DAVIS VOS mask propagation: the first frame's label map, nearest-resized
  to feature resolution and one-hot encoded, propagates through K1 with the
  square window over the whole video's bank; with `save_mem` the features
  are instead computed one frame at a time inside the loop and the keys go
  through the unbanked entry (K2), so no bank of the whole video exists.
  Each frame decodes by bilinear upsampling to the original size and an
  argmax; frame 0 is the given mask.  `hard_prop` re-encodes each propagated
  frame as a one-hot before it enters the value buffer.

cfg.matmul_precision picks the kernel's compute mode (K3), as
pallas_compute_dtype maps it: 'highest' runs 'float32', 'high' the bf16x3
'high' and 'default' 'bfloat16', with the bank stored in bfloat16.  It reaches
only the attention; the backbone runs in full float32 in every mode.

Spatial-parallel propagation (`spatial_devices`, the JAX Tracker's
`spatial_mesh`): each frame's query rows are cut into S row blocks, one per
listed device, and each block runs the kernel's row-block mode (K4) against
its device's replica of a bank over-padded to S blocks; the blocks are
gathered on the first device (the primary), cut to the feature height, and
copied back to every device to roll its value ring, so the result equals the
unsharded propagation bit for bit.  A device may be listed more than once:
each distinct device holds one replica of the backbone, the bank and the
rings, and runs its blocks one after another on its current stream, so one
card listed S times runs the same path as S cards.  Feature extraction splits
each 16-frame chunk over the distinct devices.

Differences from the JAX Tracker that leave the results unchanged: frames
and points are not padded to buckets (PyTorch runs eagerly; bucketing exists
for jit's static shapes, and windows only look backward), the bank is built
once per video instead of once per group, and the scan is a Python loop.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fgvc_tpu_torch.config import TestConfig, check_ported
from fgvc_tpu_torch.device import set_matmul_precision
from fgvc_tpu_torch.ops.attention import l2_normalize
from fgvc_tpu_torch.ops.color import preprocess_rgb_to_lab_normalized
from fgvc_tpu_torch.ops.cuda.topk_attention import (
    bank_geometry,
    pad_key_bank,
    pallas_compute_dtype,
    topk_attention,
    topk_attention_banked,
)
from fgvc_tpu_torch.ops.grids import draw_gaussian_maps, soft_argmax_topk

EXTRACT_CHUNK = 16  # frames per backbone call


def hard_onehot(seg_logit: torch.Tensor) -> torch.Tensor:
    """hard_prop re-encoding: argmax -> one-hot over the channel axis (the
    first maximal channel wins, as in jnp.argmax)."""
    P = seg_logit.shape[-1]
    return F.one_hot(seg_logit.argmax(-1), P).to(seg_logit.dtype)


def resize_labels(labels: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of an (h0, w0) integer label map: source index
    floor((i + 0.5) * scale), which is jax.image.resize's 'nearest' and
    torch's 'nearest-exact' (torch's 'nearest' floors i * scale)."""
    x = labels.to(torch.float32)[None, None]
    return F.interpolate(x, size=hw, mode="nearest-exact")[0, 0].to(torch.int32)


def upsample(logits: torch.Tensor, full_hw: Tuple[int, int]) -> torch.Tensor:
    """(h, w, K) -> (K, H, W) by bilinear interpolation with half-pixel
    centres (jax.image.resize's 'bilinear' going up)."""
    return F.interpolate(
        logits.permute(2, 0, 1)[None], size=full_hw, mode="bilinear",
        align_corners=False,
    )[0]


def decode_labels(logits: torch.Tensor, full_hw: Tuple[int, int]) -> torch.Tensor:
    """(h, w, K) logits -> (H, W) int32 labels: upsample and argmax (the
    first maximal channel wins, so an all-zero pixel gives label 0)."""
    return upsample(logits, full_hw).argmax(0).to(torch.int32)


def _full_device(device: Union[str, torch.device]) -> torch.device:
    """A device with its index: 'cuda' names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _bucket(x: int, m: int) -> int:
    return -(-x // m) * m


class Tracker:
    """Feature extraction + top-k attention label propagation.

    Args:
      backbone: module mapping (N, 3, H, W) normalised Lab to (N, C, h, w).
      cfg: propagation settings (only the main path's are ported).
      device: where the backbone, the bank and the kernels run.
      spatial_devices: S devices for spatial-parallel propagation, one row
        block each (repeats allowed); the first must be `device`.
    """

    def __init__(
        self, backbone: nn.Module, cfg: TestConfig, device: torch.device,
        spatial_devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        self.device = _full_device(device)
        self.spatial_devices = None
        if spatial_devices is not None:
            # checked before check_ported: JAX refuses these with ValueError
            if cfg.attention_impl != "pallas":
                raise ValueError(
                    "spatial-parallel propagation supports attention_impl "
                    f"'pallas', not {cfg.attention_impl!r}"
                )
            if not cfg.with_first_neighbor:
                raise ValueError(
                    "spatial-parallel propagation requires with_first_neighbor"
                )
            devs = [torch.device(d) for d in spatial_devices]
            if not devs:
                raise ValueError("spatial_devices is empty")
            if len({d.type for d in devs}) > 1:
                raise ValueError(
                    f"spatial_devices mixes device types: {[str(d) for d in devs]}"
                )
            devs = [_full_device(d) for d in devs]
            if devs[0] != self.device:
                raise ValueError(
                    f"the first of spatial_devices ({devs[0]}) must be the "
                    f"tracker's device ({self.device})"
                )
            self.spatial_devices = devs
        check_ported(cfg)
        set_matmul_precision(cfg.matmul_precision)
        self.cfg = cfg
        self.backbone = backbone.to(self.device).eval()
        # each distinct device, the primary first, with its backbone replica
        self.devices = list(dict.fromkeys(self.spatial_devices or [self.device]))
        self.backbones = {
            dev: self.backbone if dev == self.device else copy.deepcopy(self.backbone).to(dev)
            for dev in self.devices
        }
        self.radius = cfg.neighbor_range // 2
        # the kernel's query tile (the Pallas kernel capped it at 16 too)
        self.tile = min(cfg.tile, 16)
        self.compute_dtype = pallas_compute_dtype(cfg.matmul_precision)

    # ------------------------------------------------------------------ #
    # features and bank
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def features_on(self, frames: np.ndarray, device: torch.device) -> torch.Tensor:
        """(N, H, W, 3) uint8 RGB -> (N, h, w, C) float32 features, computed
        on `device` (one of self.devices) by its backbone replica; contiguous,
        so that a norm over C sums in the same order on every path."""
        x = torch.from_numpy(np.ascontiguousarray(frames))
        x = preprocess_rgb_to_lab_normalized(x.to(device))
        f = self.backbones[device](x.permute(0, 3, 1, 2).contiguous())
        return f.permute(0, 2, 3, 1).contiguous()

    @torch.no_grad()
    def extract_features(self, video: np.ndarray) -> torch.Tensor:
        """(T, H, W, 3) uint8 RGB -> (T, h, w, C) float32 features on the
        device; preprocessing runs on the device too.  Each 16-frame chunk is
        split over the distinct devices (frame-parallel, the JAX Tracker's
        sharded upload) and gathered on the primary."""
        if video.dtype != np.uint8 or video.ndim != 4:
            raise ValueError(
                f"expected (T, H, W, 3) uint8 frames, got {video.dtype} {video.shape}"
            )
        parts = []
        for i in range(0, video.shape[0], EXTRACT_CHUNK):
            chunk = video[i : i + EXTRACT_CHUNK]
            shares = np.array_split(chunk, len(self.devices))
            feats = [self.features_on(x, dev) for x, dev in zip(shares, self.devices) if len(x)]
            parts += [f.to(self.device) for f in feats]
        return torch.cat(parts).contiguous()

    def build_bank(self, feats: torch.Tensor, grid_rows: Optional[int] = None) -> torch.Tensor:
        """The normalised, halo-padded bank, in bfloat16 for compute mode
        'bfloat16' and float32 otherwise; `grid_rows` over-pads its rows for
        row blocks."""
        return pad_key_bank(
            feats, float(self.radius), tile=self.tile, normalize=self.cfg.with_norm,
            compute_dtype=self.compute_dtype, grid_rows=grid_rows,
        )

    def row_blocks(self, h: int) -> Tuple[int, int, List[int]]:
        """(hb, gridH, row0 of each block) of the spatial devices' row blocks
        over an h-row feature map: the padded rows split into S blocks of hb
        rows, a multiple of the tile (the last block may be over-padded)."""
        S = len(self.spatial_devices)
        hb = _bucket(-(-_bucket(h, self.tile) // S), self.tile)
        return hb, S * hb, [i * hb for i in range(S)]

    def replicate(self, x: torch.Tensor) -> Dict[torch.device, torch.Tensor]:
        """x on each distinct device (the tensor itself where it lies)."""
        return {dev: x.to(dev) for dev in self.devices}

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
        return soft_argmax_topk(upsample(logits, full_hw), topk=5)

    def bank_entry(self, seg_logit: torch.Tensor) -> torch.Tensor:
        """What a propagated frame leaves in the value buffer (the emitted
        decode always reads the soft logits)."""
        return hard_onehot(seg_logit) if self.cfg.hard_prop else seg_logit

    def propagate(
        self,
        bank: torch.Tensor,       # padded bank of the whole video
        t0: int,                  # first frame of the group
        length: int,              # frames t0 .. t0 + length - 1
        first: torch.Tensor,      # (h, w, P) value map of frame t0
        emit: Callable[[torch.Tensor], torch.Tensor],
        mask_shape: str = "circle",
    ) -> List[torch.Tensor]:
        """Banked propagation (K1) over frames 1 .. length - 1 of the group;
        returns emit(logits) of each."""
        cfg = self.cfg
        h, w = first.shape[:2]
        halo, Hp, Wp, _, _ = bank_geometry(h, w, self.radius, self.tile)
        buf = [first] * cfg.precede_frames                # value ring buffer
        outs = []
        for t in range(1, length):
            idx, valid = self.window_indices(t, length)
            qpad = bank[t0 + t, halo : halo + Hp, halo : halo + Wp].contiguous()
            seg = topk_attention_banked(
                qpad, bank, torch.stack([first, *buf]),
                frame_idx=[t0 + i for i in idx], key_valid=valid, H=h, W=w,
                radius=float(self.radius), temperature=cfg.temperature,
                topk=cfg.topk, tile=self.tile, mask_shape=mask_shape,
                compute_dtype=self.compute_dtype,
            )
            buf = buf[1:] + [self.bank_entry(seg)]
            outs.append(emit(seg))
        return outs

    def _sp_frame(self, banks, q, frame_idx, valid, firsts, bufs, hw, mask_shape):
        """One frame of spatial-parallel propagation: every row block attends
        from frame `q` of its device's bank (K4); the blocks are gathered on
        the primary and cut to h rows (the JAX all_gather(...)[:h]), and the
        frame's value entry rolls every device's value ring `bufs` (after
        `firsts`, frame 0's values).  Returns the gathered logits."""
        h, w = hw
        hb, gridH, row0s = self.row_blocks(h)
        halo, _, Wp, _, _ = bank_geometry(h, w, self.radius, self.tile, gridH)
        values = {dev: torch.stack([firsts[dev], *bufs[dev]]) for dev in self.devices}
        blocks = []
        for dev, row0 in zip(self.spatial_devices, row0s):
            bank = banks[dev]
            qblk = bank[q, halo + row0 : halo + row0 + hb, halo : halo + Wp]
            blocks.append(topk_attention_banked(
                qblk.contiguous(), bank, values[dev], frame_idx=frame_idx, key_valid=valid,
                H=h, W=w, radius=float(self.radius), temperature=self.cfg.temperature,
                topk=self.cfg.topk, tile=self.tile, mask_shape=mask_shape,
                compute_dtype=self.compute_dtype, row0=row0, grid_rows=gridH,
            ))
        seg = torch.cat([b.to(self.device) for b in blocks])[:h]
        entries = self.replicate(self.bank_entry(seg))
        for dev in self.devices:
            bufs[dev] = bufs[dev][1:] + [entries[dev]]
        return seg

    def propagate_sp(
        self,
        banks: Dict[torch.device, torch.Tensor],  # the over-padded bank per device
        t0: int,
        length: int,
        first: torch.Tensor,
        emit: Callable[[torch.Tensor], torch.Tensor],
        mask_shape: str = "circle",
    ) -> List[torch.Tensor]:
        """Spatial-parallel banked propagation (K4): `propagate` with each
        frame's query rows cut into one row block per spatial device."""
        firsts = self.replicate(first)
        bufs = {dev: [firsts[dev]] * self.cfg.precede_frames for dev in self.devices}
        outs = []
        for t in range(1, length):
            idx, valid = self.window_indices(t, length)
            seg = self._sp_frame(banks, t0 + t, [t0 + i for i in idx], valid, firsts, bufs,
                                 first.shape[:2], mask_shape)
            outs.append(emit(seg))
        return outs

    def propagate_streaming(
        self,
        video: np.ndarray,        # (T, H, W, 3) uint8
        f0: torch.Tensor,         # (h, w, C) features of frame 0
        first: torch.Tensor,      # (h, w, P) value map of frame 0
        emit: Callable[[torch.Tensor], torch.Tensor],
        mask_shape: str = "square",
    ) -> List[torch.Tensor]:
        """save_mem propagation (K2): each frame's features are computed
        once, at batch 1, when it becomes the query, and roll through a
        `precede_frames`-deep key buffer; no bank of the whole video.  The
        buffer keeps float32 normalised features in every mode; the entry
        casts them per call."""
        cfg = self.cfg
        P = cfg.precede_frames
        norm = l2_normalize if cfg.with_norm else (lambda x: x)
        f0 = norm(f0)
        feat_buf, value_buf = [f0] * P, [first] * P
        outs = []
        for t in range(1, video.shape[0]):
            q = norm(self.extract_features(video[t : t + 1])[0])
            valid = [cfg.with_first] + [t - P + i >= 0 for i in range(P)]
            seg = topk_attention(
                q, torch.stack([f0, *feat_buf]), torch.stack([first, *value_buf]),
                radius=float(self.radius), temperature=cfg.temperature,
                topk=cfg.topk, normalize=False, tile=self.tile,
                mask_shape=mask_shape, key_valid=valid, compute_dtype=self.compute_dtype,
            )
            feat_buf = feat_buf[1:] + [q]
            value_buf = value_buf[1:] + [self.bank_entry(seg)]
            outs.append(emit(seg))
        return outs

    def propagate_streaming_sp(
        self,
        video: np.ndarray,        # (T, H, W, 3) uint8
        f0: torch.Tensor,         # (h, w, C) features of frame 0, on the primary
        first: torch.Tensor,      # (h, w, P) value map of frame 0
        emit: Callable[[torch.Tensor], torch.Tensor],
        mask_shape: str = "square",
    ) -> List[torch.Tensor]:
        """Spatial-parallel save_mem propagation (K4), the JAX
        _scan_propagate_streaming_sp: every distinct device runs the backbone
        on the full frame and keeps a key ring of kernel-padded entries over
        the row blocks' grid, in the mode's dtype (bfloat16 in 'bfloat16');
        each block attends over frame 0 and the `precede_frames` previous
        frames of that ring as a mini-bank.  The ring has 2 + P entries: 0
        holds frame 0, and frame j >= 1 lands in entry 1 + j % (P + 1) when
        it becomes the query, whose block is cut from it; the key slots read
        their entries through frame_idx, so no mini-bank is copied."""
        cfg = self.cfg
        P = cfg.precede_frames
        norm = l2_normalize if cfg.with_norm else (lambda x: x)
        h, w = f0.shape[:2]
        gridH = self.row_blocks(h)[1]
        halo = bank_geometry(h, w, self.radius, self.tile, gridH)[0]
        rings = {}
        for dev in self.devices:
            f = norm(f0 if dev == self.device else self.features_on(video[:1], dev)[0])
            rings[dev] = pad_key_bank(
                f[None].expand(2 + P, -1, -1, -1), float(self.radius), tile=self.tile,
                normalize=False, compute_dtype=self.compute_dtype, grid_rows=gridH,
            )
        firsts = self.replicate(first)
        bufs = {dev: [firsts[dev]] * P for dev in self.devices}
        outs = []
        for t in range(1, video.shape[0]):
            pos = 1 + t % (P + 1)
            for dev in self.devices:
                q = norm(self.features_on(video[t : t + 1], dev)[0])
                rings[dev][pos, halo : halo + h, halo : halo + w] = q.to(rings[dev].dtype)
            idx = [0] + [1 + (t - P + i) % (P + 1) for i in range(P)]
            valid = [cfg.with_first] + [t - P + i >= 0 for i in range(P)]
            seg = self._sp_frame(rings, pos, idx, valid, firsts, bufs, (h, w), mask_shape)
            outs.append(emit(seg))
        return outs

    def video_bank(self, feats: torch.Tensor):
        """The bank `propagate` reads, or with spatial devices the bank
        over-padded to the row blocks' grid, per distinct device, that
        `propagate_sp` reads."""
        if self.spatial_devices is None:
            return self.build_bank(feats)
        gridH = self.row_blocks(feats.shape[1])[1]
        return self.replicate(self.build_bank(feats, grid_rows=gridH))

    def track_group(
        self, bank, t0: int, length: int, pts: torch.Tensor,
        feat_hw: Tuple[int, int], full_hw: Tuple[int, int],
    ) -> torch.Tensor:
        """One query-frame group: gaussian maps, propagation, decode.  Row 0
        decodes the full-resolution gaussian."""
        H, W = full_hw
        stride = H // feat_hw[0]
        init_maps = draw_gaussian_maps(pts, H, W, sigma=self.cfg.sigma, stride=stride)
        propagate = self.propagate if self.spatial_devices is None else self.propagate_sp
        rows = propagate(
            bank, t0, length, init_maps.permute(1, 2, 0).contiguous(),
            lambda seg: self.decode(seg, full_hw),
        )
        full_maps = draw_gaussian_maps(pts, H, W, sigma=self.cfg.sigma, stride=1)
        return torch.stack([soft_argmax_topk(full_maps, topk=5), *rows])

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
        bank = self.video_bank(feats)
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

    # ------------------------------------------------------------------ #
    # DAVIS VOS protocol
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def track_masks_dispatch(
        self,
        video: np.ndarray,        # (T, H, W, 3) uint8 RGB
        ref_mask: np.ndarray,     # (h0, w0) integer label map of frame 0
        decode_hw: Tuple[int, int],
        num_objects: int,
    ) -> Dict:
        """Queue VOS mask propagation on the device (square window; K1, or
        K2 with save_mem; K4 on either path with spatial devices);
        `track_masks_collect` reads the label maps."""
        if self.cfg.save_mem:
            f0 = self.extract_features(video[:1])[0]   # frame 0 at batch 1
            h, w = f0.shape[:2]
        else:
            feats = self.extract_features(video)
            h, w = feats.shape[1:3]
            bank = self.video_bank(feats)
            del feats  # the bank holds every frame; free the unpadded copy
        labels = torch.from_numpy(np.asarray(ref_mask, np.int32)).to(self.device)
        small = resize_labels(labels, (h, w))
        # one-hot as jax.nn.one_hot: a label above num_objects maps to zeros
        classes = torch.arange(num_objects + 1, device=self.device, dtype=torch.int32)
        onehot = (small[..., None] == classes).to(torch.float32)
        emit = lambda seg: decode_labels(seg, tuple(decode_hw))  # noqa: E731
        sp = self.spatial_devices is not None
        if self.cfg.save_mem:
            stream = self.propagate_streaming_sp if sp else self.propagate_streaming
            masks = stream(video, f0, onehot, emit)
        else:
            propagate = self.propagate_sp if sp else self.propagate
            masks = propagate(bank, 0, video.shape[0], onehot, emit, mask_shape="square")
        # frame 0 is the given mask at decode resolution
        return {"masks": [resize_labels(labels, tuple(decode_hw)), *masks]}

    def track_masks_collect(self, disp: Dict) -> np.ndarray:
        """(T, H, W) int32 label maps at decode_hw."""
        return torch.stack(disp["masks"]).cpu().numpy()

    def track_masks(
        self, video: np.ndarray, ref_mask: np.ndarray,
        decode_hw: Tuple[int, int], num_objects: int,
    ) -> np.ndarray:
        return self.track_masks_collect(
            self.track_masks_dispatch(video, ref_mask, decode_hw, num_objects)
        )
