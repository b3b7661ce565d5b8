"""Label-propagation tracker (fgvc_tpu/models/tracker.py).

Three protocols share one propagation loop:

* TAP-Vid point tracking: uint8 frames -> Lab (or ImageNet-normalised RGB,
  by cfg.preprocess) -> encoder features (16-frame chunks, on the device)
  -> one key bank per video -> for each group of points sharing a query
  frame, a loop over the following frames, each attending over frame 0 of
  the group plus the `precede_frames` preceding frames (circle window) ->
  bilinear upsample to the input size and top-5 soft-argmax (with
  decode_impl 'coarse': the soft-argmax at feature resolution, scaled), and
  the map's peak, whose ratio to the query frame's peak is the visibility
  under visibility_mode 'heatmap'.
* DAVIS VOS mask propagation: the first frame's label map, nearest-resized
  to feature resolution and one-hot encoded, propagates with the square
  window over the whole video's bank; with `save_mem` the features are
  instead computed one frame at a time inside the loop and roll through a
  key buffer, so no bank of the whole video exists.  Each frame decodes by
  bilinear upsampling to the original size and an argmax; frame 0 is the
  given mask.  `hard_prop` re-encodes each propagated frame as a one-hot
  before it enters the value buffer.
* JHMDB / BADJA keypoint propagation: reference heatmaps, resized to
  feature resolution as jax.image.resize does (antialiased), propagate from
  frame 0 with the square window; each frame decodes as in TAP-Vid, at the
  reader's decode size.

The attention of a propagated frame (cfg.attention_impl, as the JAX Tracker
picks it):
* 'pallas': the top-k attention kernel over a bank normalised and
  halo-padded once (K1; K2, the unbanked entry, with save_mem).
  cfg.matmul_precision picks its compute mode (K3), as pallas_compute_dtype
  maps it: 'highest' runs 'float32', 'high' the bf16x3 'high' and 'default'
  'bfloat16', with the bank stored in bfloat16.
* 'tiled': ops/windowed_attention.py over a bank normalised and
  halo-padded once (tile = cfg.tile, not capped), by cfg.topk_impl.
* 'dense': ops/attention.py masked_topk_attention, cfg.step query pixels
  a chunk; every attention_impl runs it where with_first_neighbor is False
  (frame 0's key slot exempt from the radius window), as in fgvc_tpu.
* 'c2f': ops/c2f.py on c2f_scale x average-pooled features (renormalised)
  and the features, lifted back to the feature grid bilinearly.
* 'flow_guided': ops/c2f.py flow_guided_topk_attention around the key
  window's flows, chained (ops/warp.py chain_window_flows) from adjacent
  feature flows (`adjacent_feature_flows`); not with save_mem.
matmul_precision reaches only the attention; the backbone runs in full
float32 in every mode.

Spatial-parallel propagation (`spatial_devices`, the JAX Tracker's
`spatial_mesh`; attention_impl 'pallas' or 'tiled'): each frame's query rows
are cut into S row blocks, one per listed device, and each block runs the
kernel's row-block mode (K4), or 'tiled''s, against its device's replica of
a bank over-padded to S blocks; the blocks are gathered on the first device
(the primary), cut to the feature height, and copied back to every device to
roll its value ring, so the result equals the unsharded propagation bit for
bit.  A device may be listed more than once: each distinct device holds one
replica of the backbone, the bank and the rings, and runs its blocks one
after another on its current stream, so one card listed S times runs the
same path as S cards.  Feature extraction splits each 16-frame chunk over
the distinct devices.

Bank-parallel propagation (`bank_devices`, the JAX Tracker's `bank_mesh`;
attention_impl 'tiled' only): the bank's frames are cut into n contiguous
shards of ceil(T / n) frames, one per listed device, and each device
extracts, normalises and pads only its own frames (16 a chunk), so no device
holds the whole bank; shards past the video are zeros.  Each frame's query
comes from its owner shard, the value ring stays on the primary, and the
attention takes each shard's local top-k on its device and merges them on the
primary (ops/windowed_attention.py
masked_topk_attention_tiled_bank_sharded).  As with spatial devices, one card
listed n times runs the path of n cards.

`track_points_forward` tracks points by forward-warping a coordinate map
instead (the reference's HRVanillaTracker forward_test_forward).

With cfg.upload_format 'yuv420' the bulk feature routes (extract_features:
the bank, spatial devices, bank shards, forward tracking) encode an
even-sized (T, H, W, 3) uint8 video to I420 planes on the host before the
upload (ops/color.py rgb_to_yuv420_host), half the bytes of RGB, and
features_on decodes planes on the device before cfg.preprocess; a (T, H*3/2,
W) uint8 array is taken as planes as it is.  save_mem's streaming reads RGB
frames, as the JAX Tracker's does.

Differences from the JAX Tracker that leave the results unchanged: frames
and points are not padded to buckets (PyTorch runs eagerly; bucketing exists
for jit's static shapes, and windows only look backward), the bank is built
once per video instead of once per group, 'tiled' always reads the window's
frames from the bank (fgvc_tpu gathers them first past 160 frames, for the
TPU's gather locality), and the scan is a Python loop.
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
from fgvc_tpu_torch.ops import windowed_attention
from fgvc_tpu_torch.ops.attention import l2_normalize, masked_topk_attention
from fgvc_tpu_torch.ops.c2f import flow_guided_topk_attention, masked_attention_c2f
from fgvc_tpu_torch.ops.color import preprocess_fns, rgb_to_yuv420_host
from fgvc_tpu_torch.ops.cuda.topk_attention import (
    bank_geometry,
    pad_key_bank,
    pallas_compute_dtype,
    topk_attention,
    topk_attention_banked,
)
from fgvc_tpu_torch.ops.grids import draw_gaussian_maps, soft_argmax_topk
from fgvc_tpu_torch.ops.local_corr import local_correlation
from fgvc_tpu_torch.ops.misc import resize_bilinear
from fgvc_tpu_torch.ops.topk import top_k
from fgvc_tpu_torch.ops.warp import bilinear_sample, chain_window_flows

EXTRACT_CHUNK = 16  # frames per backbone call
FLOW_PAIRS = 8      # frame pairs a local-correlation call of adjacent_feature_flows


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
    centres, as jax.image.resize's 'bilinear' goes up (ops/misc): the
    borders past the last feature centre are exact plateaus, so the
    decode's top-k breaks their ties as JAX does."""
    return resize_bilinear(logits.permute(2, 0, 1), full_hw)


def resize_maps(maps: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(h0, w0, P) -> (h, w, P) as jax.image.resize(..., 'bilinear') does:
    half-pixel centres, and a triangle filter widened by the scale where it
    shrinks an axis (antialiasing, which a plain bilinear downscale lacks),
    by its weight matrices (ops/misc): a Gaussian's peak on the decode grid
    is a plateau of exact ties, which the frame-0 top-5 soft-argmax breaks
    as JAX does only where the values are JAX's to the bit."""
    return resize_bilinear(maps.permute(2, 0, 1), hw).permute(1, 2, 0)


def decode_labels(logits: torch.Tensor, full_hw: Tuple[int, int]) -> torch.Tensor:
    """(h, w, K) logits -> (H, W) int32 labels: upsample and argmax (the
    first maximal channel wins, so an all-zero pixel gives label 0)."""
    return upsample(logits, full_hw).argmax(0).to(torch.int32)


def full_device(device: Union[str, torch.device]) -> torch.device:
    """A device with its index: 'cuda' names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_video(video: np.ndarray) -> None:
    if video.dtype != np.uint8 or video.ndim not in (3, 4):
        raise ValueError(
            f"expected (T, H, W, 3) uint8 frames or (T, H*3/2, W) uint8 I420 planes, "
            f"got {video.dtype} {video.shape}"
        )


def _bucket(x: int, m: int) -> int:
    return -(-x // m) * m


class Tracker:
    """Feature extraction + top-k attention label propagation.

    Args:
      backbone: module mapping (N, 3, H, W) preprocessed frames to (N, C, h,
        w): normalised Lab where cfg.preprocess is 'lab', ImageNet-normalised
        RGB where it is 'imagenet'.
      cfg: propagation settings.
      device: where the backbone, the bank and the attention run.
      spatial_devices: S devices for spatial-parallel propagation, one row
        block each (repeats allowed); the first must be `device`.
      bank_devices: n devices for bank-parallel propagation, one frame shard
        each (repeats allowed); the first must be `device`.
    """

    def __init__(
        self, backbone: nn.Module, cfg: TestConfig, device: torch.device,
        spatial_devices: Optional[Sequence[Union[str, torch.device]]] = None,
        bank_devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        self.device = full_device(device)
        self.spatial_devices = self.bank_devices = None
        if spatial_devices is not None and bank_devices is not None:
            raise ValueError(
                "spatial_devices and bank_devices are separate scaling axes; "
                "pass at most one (composition is not implemented)"
            )
        if bank_devices is not None:
            # fgvc_tpu's checks and messages, before check_ported as there
            if cfg.attention_impl != "tiled":
                raise ValueError(
                    "bank-parallel propagation supports attention_impl "
                    f"'tiled', not {cfg.attention_impl!r}"
                )
            if cfg.topk is None:
                raise ValueError("bank-parallel propagation requires topk")
            if not cfg.with_first_neighbor:
                raise ValueError("bank-parallel propagation requires with_first_neighbor")
            if cfg.save_mem:
                raise ValueError(
                    "bank_devices shards the feature BANK; save_mem streaming "
                    "keeps no bank (use spatial_devices there instead)"
                )
            self.bank_devices = self._device_list(bank_devices, "bank_devices")
        if spatial_devices is not None:
            # checked before check_ported: JAX refuses these with ValueError
            if cfg.attention_impl not in ("pallas", "tiled"):
                raise ValueError(
                    "spatial-parallel propagation supports attention_impl "
                    f"'pallas'/'tiled', not {cfg.attention_impl!r}"
                )
            if not cfg.with_first_neighbor:
                raise ValueError(
                    "spatial-parallel propagation requires with_first_neighbor"
                )
            self.spatial_devices = self._device_list(spatial_devices, "spatial_devices")
        check_ported(cfg)
        set_matmul_precision(cfg.matmul_precision)
        self.cfg = cfg
        self.backbone = backbone.to(self.device).eval()
        # each distinct device, the primary first, with its backbone replica
        self.devices = list(dict.fromkeys(
            self.spatial_devices or self.bank_devices or [self.device]))
        self.backbones = {
            dev: self.backbone if dev == self.device else copy.deepcopy(self.backbone).to(dev)
            for dev in self.devices
        }
        self.radius = cfg.neighbor_range // 2
        # the loop that reads the bank: the kernel's and 'tiled''s over a
        # padded bank, 'flow_guided''s over chained flows, and the loop of
        # every other mode over the normalised features (_scan_propagate)
        impl = cfg.attention_impl if cfg.with_first_neighbor else "dense"
        self.path = {"pallas": "kernel", "tiled": "tiled", "flow_guided": "flow"}.get(impl, "legacy")
        # the query tile: the kernel caps it at 16 (the Pallas kernel did too)
        self.tile = cfg.tile if cfg.attention_impl == "tiled" else min(cfg.tile, 16)
        self.compute_dtype = pallas_compute_dtype(cfg.matmul_precision)
        self.preprocess, self.preprocess_yuv = preprocess_fns(cfg.preprocess)

    def _device_list(self, devices, name: str) -> List[torch.device]:
        """`devices` with their indices: one type, the tracker's device
        first."""
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError(f"{name} is empty")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"{name} mixes device types: {[str(d) for d in devs]}")
        devs = [full_device(d) for d in devs]
        if devs[0] != self.device:
            raise ValueError(
                f"the first of {name} ({devs[0]}) must be the tracker's device ({self.device})"
            )
        return devs

    # ------------------------------------------------------------------ #
    # features and bank
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def features_on(self, frames: np.ndarray, device: torch.device) -> torch.Tensor:
        """(N, H, W, 3) uint8 RGB, or (N, H*3/2, W) uint8 I420 planes ->
        (N, h, w, C) float32 features, computed on `device` (one of
        self.devices) by its backbone replica after cfg.preprocess (planes
        decoded first; every path, banked and streaming, comes here);
        contiguous, so that a norm over C sums in the same order on every
        path."""
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
        x = self.preprocess_yuv(x) if x.ndim == 3 else self.preprocess(x)
        f = self.backbones[device](x.permute(0, 3, 1, 2).contiguous())
        return f.permute(0, 2, 3, 1).contiguous()

    def upload_video(self, video: np.ndarray) -> np.ndarray:
        """What the bulk feature routes upload: under upload_format 'yuv420'
        an even-sized (T, H, W, 3) uint8 video as I420 planes (T, H*3/2, W),
        encoded on the host; anything else as it is."""
        if (self.cfg.upload_format == "yuv420" and isinstance(video, np.ndarray)
                and video.dtype == np.uint8 and video.ndim == 4
                and video.shape[1] % 2 == 0 and video.shape[2] % 2 == 0):
            return rgb_to_yuv420_host(video)
        return video

    @torch.no_grad()
    def extract_features(self, video: np.ndarray) -> torch.Tensor:
        """(T, H, W, 3) uint8 RGB, or (T, H*3/2, W) I420 planes -> (T, h, w,
        C) float32 features on the device, the video uploaded as
        upload_video gives it; preprocessing runs on the device.  Each
        16-frame chunk is split over the distinct devices (frame-parallel, the
        JAX Tracker's sharded upload) and gathered on the primary."""
        return self._extract(self.upload_video(video))

    def _extract(self, video: np.ndarray) -> torch.Tensor:
        _check_video(video)
        parts = []
        for i in range(0, video.shape[0], EXTRACT_CHUNK):
            chunk = video[i : i + EXTRACT_CHUNK]
            shares = np.array_split(chunk, len(self.devices))
            feats = [self.features_on(x, dev) for x, dev in zip(shares, self.devices) if len(x)]
            parts += [f.to(self.device) for f in feats]
        return torch.cat(parts).contiguous()

    def pad_features(self, feats: torch.Tensor, normalize: bool,
                     grid_rows: Optional[int] = None) -> torch.Tensor:
        """(Tb, h, w, C) features halo-padded for the bank-reading loops,
        normalised first where `normalize`: the kernel's geometry and dtype
        (bfloat16 for compute mode 'bfloat16') for 'pallas', 'tiled''s
        (float32) otherwise; `grid_rows` over-pads the rows for row
        blocks."""
        if self.path == "kernel":
            return pad_key_bank(
                feats, float(self.radius), tile=self.tile, normalize=normalize,
                compute_dtype=self.compute_dtype, grid_rows=grid_rows,
            )
        if normalize:
            return windowed_attention.pad_key_bank(feats, float(self.radius), self.tile,
                                                   grid_rows=grid_rows)
        h, w = feats.shape[1:3]
        halo = int(self.radius)
        Hp = _bucket(h, self.tile) if grid_rows is None else grid_rows
        return F.pad(feats, (0, 0, halo, halo + _bucket(w, self.tile) - w, halo, halo + Hp - h))

    def build_bank(self, feats: torch.Tensor, grid_rows: Optional[int] = None) -> torch.Tensor:
        """What the propagation loop reads for a video's features: for
        'pallas' and 'tiled' (with_first_neighbor) the bank, normalised
        where cfg.with_norm and halo-padded once (pad_features); for the
        other modes the features, normalised where cfg.with_norm."""
        if self.path in ("kernel", "tiled"):
            return self.pad_features(feats, self.cfg.with_norm, grid_rows)
        return l2_normalize(feats) if self.cfg.with_norm else feats

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
        """(h, w, P) logits -> (P, 3): (x, y) at full resolution and the
        peak of the logits over (h, w), which visibility_mode 'heatmap'
        reads.  decode_impl 'coarse' takes the top-5 soft-argmax at feature
        resolution scaled by (W / w, H / h) (-1 where a coordinate is
        negative); 'upsample' and 'window' upsample bilinearly first."""
        peak = logits.amax(dim=(0, 1))
        if self.cfg.decode_impl == "coarse":
            H, W = full_hw
            h, w = logits.shape[:2]
            c = soft_argmax_topk(logits.permute(2, 0, 1), topk=5)
            # Python scalars: a tensor made from them here would be a host
            # copy, which waits for the card's queue every frame
            scaled = torch.stack([c[:, 0] * (W / w), c[:, 1] * (H / h)], dim=-1)
            coords = torch.where(c < 0, -1.0, scaled)
        else:
            coords = soft_argmax_topk(upsample(logits, full_hw), topk=5)
        return torch.cat([coords, peak[:, None]], dim=-1)

    def bank_entry(self, seg_logit: torch.Tensor) -> torch.Tensor:
        """What a propagated frame leaves in the value buffer (the emitted
        decode always reads the soft logits)."""
        return hard_onehot(seg_logit) if self.cfg.hard_prop else seg_logit

    def attention_step(
        self, query: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
        key_valid: List[bool], mask_shape: str, pre_normalized: bool = False,
    ) -> torch.Tensor:
        """One frame's attention over raw (or `pre_normalized`) key features
        (the JAX Tracker's _attention_step), by cfg.attention_impl; the
        save_mem loop and every mode but 'pallas', 'tiled' and
        'flow_guided' with with_first_neighbor take it."""
        cfg = self.cfg
        radius = float(self.radius)
        non_mask_len = 0 if cfg.with_first_neighbor else 1
        do_norm = cfg.with_norm and not pre_normalized
        impl = cfg.attention_impl
        if impl == "flow_guided":
            raise ValueError(
                "attention_impl='flow_guided' needs with_first_neighbor=True and runs "
                "in the bank propagation loop (track_points/track_heatmaps/track_masks "
                "without save_mem)"
            )
        if impl == "c2f" and non_mask_len == 0:
            return self._c2f_step(query, keys, values, key_valid, do_norm)
        if impl == "pallas" and non_mask_len == 0:
            return topk_attention(
                query, keys, values, radius=radius, temperature=cfg.temperature,
                topk=cfg.topk, normalize=do_norm, tile=self.tile, mask_shape=mask_shape,
                key_valid=key_valid, compute_dtype=self.compute_dtype,
            )
        if impl == "tiled" and non_mask_len == 0:
            return windowed_attention.masked_topk_attention_tiled(
                query, keys, values, radius=radius, temperature=cfg.temperature,
                topk=cfg.topk, normalize=do_norm, tile=cfg.tile, mask_shape=mask_shape,
                key_valid=key_valid, precision=cfg.matmul_precision, topk_impl=cfg.topk_impl,
            )
        return masked_topk_attention(
            query, keys, values, radius=radius, temperature=cfg.temperature,
            topk=cfg.topk, normalize=do_norm, step=cfg.step, non_mask_len=non_mask_len,
            mask_shape=mask_shape, key_valid=key_valid, precision=cfg.matmul_precision,
        )

    def _c2f_step(self, query, keys, values, key_valid, do_norm):
        """'c2f': the coarse stage on c2f_scale x average-pooled features
        (renormalised under with_norm), the fine stage on the features; the
        coarse grid's output lifted to the feature grid as
        jax.image.resize(..., 'bilinear') does."""
        cfg = self.cfg
        s = cfg.c2f_scale
        h, w = query.shape[:2]
        if h % s or w % s:
            raise ValueError(
                f"attention_impl='c2f' needs feature dims divisible by c2f_scale={s}; "
                f"got {h}x{w} (pick an input_size whose stride-2 feature map is a "
                f"multiple of {s})"
            )
        qf, kf = (l2_normalize(query), l2_normalize(keys)) if do_norm else (query, keys)

        def pool(x):
            return x.reshape(*x.shape[:-3], h // s, s, w // s, s, x.shape[-1]).mean(dim=(-4, -2))

        qc, kc = pool(qf), pool(kf)
        if cfg.with_norm:
            qc, kc = l2_normalize(qc), l2_normalize(kc)
        out_c = masked_attention_c2f(
            qc, kc, qf, kf, values, radius=float(self.radius) / s, radius_fine=cfg.radius_fine,
            temperature=cfg.temperature, topk=cfg.topk, normalize=False, key_valid=key_valid,
            step=cfg.c2f_step,
        )
        return resize_bilinear(out_c.permute(2, 0, 1), (h, w)).permute(1, 2, 0).contiguous()

    def propagate(
        self,
        bank: torch.Tensor,       # build_bank of the whole video
        t0: int,                  # first frame of the group
        length: int,              # frames t0 .. t0 + length - 1
        first: torch.Tensor,      # (h, w, P) value map of frame t0
        emit: Callable[[torch.Tensor], torch.Tensor],
        mask_shape: str = "circle",
    ) -> List[torch.Tensor]:
        """Propagation over frames 1 .. length - 1 of the group; returns
        emit(logits) of each.  The key slots of frame t are frame 0 of the
        group and the `precede_frames` before t (window_indices); the value
        ring holds the logits (or hard_prop's one-hots) of those frames.
        'pallas' (K1) and 'tiled' read the slots' frames from the padded
        bank at global indices; 'flow_guided' attends around the window's
        chained flows; the other modes take attention_step over the
        normalised features.  With bank devices `bank` is the list of frame
        shards, and propagate_bank runs the group."""
        if self.bank_devices is not None:
            return self.propagate_bank(bank, t0, length, first, emit, mask_shape)
        cfg = self.cfg
        h, w = first.shape[:2]
        radius = float(self.radius)
        halo, Hp, Wp, _, _ = bank_geometry(h, w, self.radius, self.tile)
        if self.path == "flow" and length > 1:
            feats = bank[t0:t0 + length]
            wflows = chain_window_flows(self.adjacent_feature_flows(feats), cfg.precede_frames)
        buf = [first] * cfg.precede_frames                # value ring buffer
        outs = []
        for t in range(1, length):
            idx, valid = self.window_indices(t, length)
            values = torch.stack([first, *buf])
            if self.path == "kernel":
                seg = topk_attention_banked(
                    bank[t0 + t, halo:halo + Hp, halo:halo + Wp].contiguous(), bank, values,
                    frame_idx=[t0 + i for i in idx], key_valid=valid, H=h, W=w, radius=radius,
                    temperature=cfg.temperature, topk=cfg.topk, tile=self.tile,
                    mask_shape=mask_shape, compute_dtype=self.compute_dtype,
                )
            elif self.path == "tiled":
                seg = windowed_attention.masked_topk_attention_tiled(
                    bank[t0 + t, halo:halo + h, halo:halo + w], bank, values, radius=radius,
                    temperature=cfg.temperature, topk=cfg.topk, normalize=False,
                    tile=self.tile, mask_shape=mask_shape, key_valid=valid,
                    precision=cfg.matmul_precision, topk_impl=cfg.topk_impl,
                    frame_idx=[t0 + i for i in idx],
                )
            elif self.path == "flow":
                seg = flow_guided_topk_attention(
                    feats[t], torch.stack([feats[i] for i in idx]), values, wflows[t - 1],
                    radius=cfg.flow_radius, temperature=cfg.temperature, topk=cfg.topk,
                    normalize=False, key_valid=valid, step=cfg.flow_step,
                )
            else:
                seg = self.attention_step(
                    bank[t0 + t], torch.stack([bank[t0 + i] for i in idx]), values, valid,
                    mask_shape, pre_normalized=cfg.with_norm,
                )
            buf = buf[1:] + [self.bank_entry(seg)]
            outs.append(emit(seg))
        return outs

    def propagate_bank(
        self,
        shards: List[torch.Tensor],  # bank_shards: frames [i * Ts, (i + 1) * Ts) each
        t0: int,
        length: int,
        first: torch.Tensor,
        emit: Callable[[torch.Tensor], torch.Tensor],
        mask_shape: str = "circle",
    ) -> List[torch.Tensor]:
        """Bank-parallel propagation (the JAX _scan_propagate_bank): frames are
        addressed globally from t0 and never sliced out of the shards; each
        frame's query is read from the shard that owns it, and its attention
        merges the shards' top-k (masked_topk_attention_tiled_bank_sharded);
        the value ring stays on the primary."""
        cfg = self.cfg
        h, w = first.shape[:2]
        halo = int(self.radius)
        Ts = shards[0].shape[0]
        shard_lo = [i * Ts for i in range(len(shards))]
        buf = [first] * cfg.precede_frames
        outs = []
        for t in range(1, length):
            idx, valid = self.window_indices(t, length)
            g = t0 + t
            query = shards[g // Ts][g % Ts, halo:halo + h, halo:halo + w].to(self.device)
            seg = windowed_attention.masked_topk_attention_tiled_bank_sharded(
                query, shards, torch.stack([first, *buf]), frame_idx=[t0 + i for i in idx],
                shard_lo=shard_lo, key_valid=valid, radius=float(self.radius),
                temperature=cfg.temperature, topk=cfg.topk, tile=self.tile,
                mask_shape=mask_shape, precision=cfg.matmul_precision,
            )
            buf = buf[1:] + [self.bank_entry(seg)]
            outs.append(emit(seg))
        return outs

    def adjacent_feature_flows(self, featsn: torch.Tensor) -> torch.Tensor:
        """(T-1, h, w, 2) backward flows t+1 -> t of (T, h, w, C) features
        (normalised under with_norm): each frame-(t+1) pixel's top-k
        softmax expected displacement over its neighbor_range local
        correlation against frame t (FLOW_PAIRS pairs a call)."""
        cfg = self.cfg
        r = self.radius
        win = 2 * r + 1
        h, w = featsn.shape[1:3]
        flows = []
        for i in range(0, featsn.shape[0] - 1, FLOW_PAIRS):
            j = min(featsn.shape[0] - 1, i + FLOW_PAIRS)
            corr = local_correlation(featsn[i + 1:j + 1], featsn[i:j], r)
            wts, idx = top_k(corr.reshape(j - i, h, w, win * win), cfg.topk)
            wts = torch.softmax(wts / cfg.temperature, dim=-1)
            di = torch.div(idx, win, rounding_mode="floor").float() - r
            dj = (idx % win).float() - r
            flows.append(torch.stack([torch.sum(wts * dj, -1), torch.sum(wts * di, -1)], -1))
        return torch.cat(flows)

    def _block(self, bank, q, frame_idx, valid, values, hw, row0, mask_shape):
        """Row block `row0` of frame `q` of a bank over-padded to the row
        blocks' grid: (hb, w, Cv) rows, K4's or 'tiled''s; rows at or past h
        are zero (K4) or garbage ('tiled'), cut by the caller."""
        cfg = self.cfg
        h, w = hw
        hb, gridH, _ = self.row_blocks(h)
        halo, _, Wp, _, _ = bank_geometry(h, w, self.radius, self.tile, gridH)
        if self.path == "tiled":
            return windowed_attention.masked_topk_attention_tiled(
                bank[q, halo + row0:halo + row0 + hb, halo:halo + w], bank, values,
                radius=float(self.radius), temperature=cfg.temperature, topk=cfg.topk,
                normalize=False, tile=self.tile, mask_shape=mask_shape, key_valid=valid,
                precision=cfg.matmul_precision, topk_impl=cfg.topk_impl, frame_idx=frame_idx,
                row_offset=row0, full_h=h, grid_rows=gridH,
            )
        return topk_attention_banked(
            bank[q, halo + row0:halo + row0 + hb, halo:halo + Wp].contiguous(), bank, values,
            frame_idx=frame_idx, key_valid=valid, H=h, W=w, radius=float(self.radius),
            temperature=cfg.temperature, topk=cfg.topk, tile=self.tile, mask_shape=mask_shape,
            compute_dtype=self.compute_dtype, row0=row0, grid_rows=gridH,
        )

    def _sp_frame(self, banks, q, frame_idx, valid, firsts, bufs, hw, mask_shape):
        """One frame of spatial-parallel propagation: every row block attends
        from frame `q` of its device's bank (K4, or 'tiled''s row blocks);
        the blocks are gathered on the primary and cut to h rows (the JAX
        all_gather(...)[:h]), and the frame's value entry rolls every
        device's value ring `bufs` (after `firsts`, frame 0's values).
        Returns the gathered logits."""
        values = {dev: torch.stack([firsts[dev], *bufs[dev]]) for dev in self.devices}
        blocks = [
            self._block(banks[dev], q, frame_idx, valid, values[dev], hw, row0, mask_shape)
            for dev, row0 in zip(self.spatial_devices, self.row_blocks(hw[0])[2])
        ]
        seg = torch.cat([b.to(self.device) for b in blocks])[:hw[0]]
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
        """Spatial-parallel banked propagation: `propagate` with each
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
        """save_mem propagation: each frame's features are computed once, at
        batch 1, when it becomes the query, and roll through a
        `precede_frames`-deep key buffer of float32 normalised features; no
        bank of the whole video.  Each frame takes attention_step ('pallas':
        the unbanked entry K2, which casts the keys per call)."""
        cfg = self.cfg
        P = cfg.precede_frames
        norm = l2_normalize if cfg.with_norm else (lambda x: x)
        f0 = norm(f0)
        feat_buf, value_buf = [f0] * P, [first] * P
        outs = []
        for t in range(1, video.shape[0]):
            q = norm(self._extract(video[t : t + 1])[0])
            valid = [cfg.with_first] + [t - P + i >= 0 for i in range(P)]
            seg = self.attention_step(
                q, torch.stack([f0, *feat_buf]), torch.stack([first, *value_buf]), valid,
                mask_shape, pre_normalized=cfg.with_norm,
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
        """Spatial-parallel save_mem propagation (the JAX
        _scan_propagate_streaming_sp): every distinct device runs the backbone
        on the full frame and keeps a key ring of padded entries over the row
        blocks' grid (pad_features: the kernel's layout and the mode's dtype,
        bfloat16 in 'bfloat16', or 'tiled''s); each block attends over frame 0
        and the `precede_frames` previous frames of that ring as a mini-bank.
        The ring has 2 + P entries: 0 holds frame 0, and frame j >= 1 lands in
        entry 1 + j % (P + 1) when it becomes the query, whose block is cut
        from it; the key slots read their entries through frame_idx, so no
        mini-bank is copied."""
        cfg = self.cfg
        P = cfg.precede_frames
        norm = l2_normalize if cfg.with_norm else (lambda x: x)
        h, w = f0.shape[:2]
        gridH = self.row_blocks(h)[1]
        halo = int(self.radius)
        rings = {}
        for dev in self.devices:
            f = norm(f0 if dev == self.device else self.features_on(video[:1], dev)[0])
            rings[dev] = self.pad_features(f[None].expand(2 + P, -1, -1, -1), False, gridH)
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

    def video_bank(self, video: np.ndarray, feats: Optional[torch.Tensor] = None):
        """What the propagation reads for a video, and its feature grid (h, w):
        build_bank of its features (extracted here unless `feats` are given);
        with spatial devices that bank over-padded to the row blocks' grid,
        per distinct device, that `propagate_sp` reads; with bank devices its
        frame shards (bank_shards)."""
        if self.bank_devices is not None:
            return self.bank_shards(video, feats)
        if feats is None:
            feats = self.extract_features(video)
        hw = tuple(feats.shape[1:3])
        if self.spatial_devices is None:
            return self.build_bank(feats), hw
        gridH = self.row_blocks(hw[0])[1]
        return self.replicate(self.build_bank(feats, grid_rows=gridH)), hw

    @torch.no_grad()
    def bank_shards(self, video: np.ndarray, feats: Optional[torch.Tensor] = None):
        """The bank born sharded, and the feature grid (h, w): shard i holds
        frames [i * Ts, (i + 1) * Ts), Ts = ceil(T / n), normalised and
        halo-padded (build_bank) on bank_devices[i], which extracts them
        itself, 16 frames a call (or takes them from `feats`); a shard past
        the video is zeros.  A device's high-water mark is its shard and one
        chunk, never the whole bank."""
        if feats is None:
            video = self.upload_video(video)
            _check_video(video)
        T = len(video) if feats is None else feats.shape[0]
        Ts = -(-T // len(self.bank_devices))
        shards, hw = [], None
        for i, dev in enumerate(self.bank_devices):
            lo, hi = i * Ts, min(T, (i + 1) * Ts)
            shard = None
            for j in range(lo, hi, EXTRACT_CHUNK):
                k = min(hi, j + EXTRACT_CHUNK)
                f = self.features_on(video[j:k], dev) if feats is None else feats[j:k].to(dev)
                hw = hw or tuple(f.shape[1:3])
                b = self.build_bank(f)
                if shard is None:
                    shard = b.new_zeros((Ts, *b.shape[1:]))
                shard[j - lo:k - lo] = b
            shards.append(shard if shard is not None else torch.zeros_like(shards[0], device=dev))
        return shards, hw

    def track_group(
        self, bank, t0: int, length: int, pts: torch.Tensor,
        feat_hw: Tuple[int, int], full_hw: Tuple[int, int],
    ) -> torch.Tensor:
        """One query-frame group: gaussian maps, propagation, decode; (T', P,
        3) rows.  Row 0 holds the full-resolution gaussian's coordinates and
        the peak of the feature-resolution maps that propagation starts
        from (the denominator of the visibility ratio)."""
        H, W = full_hw
        stride = H // feat_hw[0]
        init_maps = draw_gaussian_maps(pts, H, W, sigma=self.cfg.sigma, stride=stride)
        propagate = self.propagate if self.spatial_devices is None else self.propagate_sp
        rows = propagate(
            bank, t0, length, init_maps.permute(1, 2, 0).contiguous(),
            lambda seg: self.decode(seg, full_hw),
        )
        full_maps = draw_gaussian_maps(pts, H, W, sigma=self.cfg.sigma, stride=1)
        row0 = torch.cat([soft_argmax_topk(full_maps, topk=5),
                          init_maps.amax(dim=(1, 2))[:, None]], dim=-1)
        return torch.stack([row0, *rows])

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
        bank, feat_hw = self.video_bank(video, feats)
        del feats  # the bank holds every frame (a 250-frame video's features are 4.2 GB)
        qt = query_points[:, 0].astype(np.int64)
        pending = []
        for t in np.unique(qt):
            sel = np.nonzero(qt == t)[0]
            pts = torch.from_numpy(
                np.ascontiguousarray(query_points[sel, 1:], dtype=np.float32)
            ).to(self.device)
            rows = self.track_group(bank, int(t), T - int(t), pts, feat_hw, (H, W))
            pending.append((int(t), sel, rows))
        return {"pending": pending, "T": T, "P": query_points.shape[0]}

    @staticmethod
    def peak_ratios(rows: np.ndarray) -> np.ndarray:
        """Each frame's peak over the query frame's for one group's (T', n,
        3) decode rows (row 0 the query frame): the statistic that
        visibility_mode 'heatmap' thresholds."""
        peaks = np.asarray(rows)[..., 2]
        return peaks / np.maximum(peaks[0], 1e-12)

    def track_points_collect(self, disp: Dict) -> Dict[str, np.ndarray]:
        """Trajectories (T, P, 2); frames before a point's query frame stay
        0.  Visibilities: under visibility_mode 'heatmap', peak ratio >=
        cfg.visibility_threshold from the query frame on (False before it);
        under 'none', all False."""
        T, P = disp["T"], disp["P"]
        traj = np.zeros((T, P, 2), dtype=np.float32)
        vis = np.zeros((T, P), dtype=bool)
        for t, sel, rows in disp["pending"]:
            arr = rows.cpu().numpy()
            traj[t:, sel] = arr[..., :2]
            if self.cfg.visibility_mode == "heatmap":
                vis[t:, sel] = self.peak_ratios(arr) >= self.cfg.visibility_threshold
        return {"trajectories": traj, "visibilities": vis}

    def track_points(
        self, video: np.ndarray, query_points: np.ndarray,
        feats: Optional[torch.Tensor] = None,
    ) -> Dict[str, np.ndarray]:
        return self.track_points_collect(
            self.track_points_dispatch(video, query_points, feats=feats)
        )

    # ------------------------------------------------------------------ #
    # forward-warp coordinate tracking
    # ------------------------------------------------------------------ #
    def forward_coords(self, feats: torch.Tensor, init_coords: torch.Tensor,
                       full_hw: Tuple[int, int]) -> torch.Tensor:
        """(T, P, 2) positions of (P, 2) (x, y) full-resolution points from
        frame 0 of (T, h, w, C) features (the reference's HRVanillaTracker
        forward_test_forward): each frame's square-window correlation
        against the window's first frame (t - precede_frames, clipped to 0)
        gives every pixel of that frame the top-k softmax expected
        full-resolution position in frame t (window slots outside the image
        count as (0, 0), the reference's zero padding); each point samples
        that map bilinearly at its running position."""
        cfg = self.cfg
        T, h, w, _ = feats.shape
        scale = full_hw[0] // h
        r = self.radius
        win = 2 * r + 1
        featsn = l2_normalize(feats) if cfg.with_norm else feats
        gy, gx = torch.meshgrid(torch.arange(h, device=feats.device, dtype=torch.float32),
                                torch.arange(w, device=feats.device, dtype=torch.float32),
                                indexing="ij")
        coord, rows = init_coords, [init_coords]
        for t in range(1, T):
            corr = local_correlation(featsn[max(t - cfg.precede_frames, 0)], featsn[t], r)
            wts, idx = top_k(corr.reshape(h, w, win * win), cfg.topk)
            wts = torch.softmax(wts / cfg.temperature, dim=-1)
            ky = gy[..., None] + (torch.div(idx, win, rounding_mode="floor").float() - r)
            kx = gx[..., None] + ((idx % win).float() - r)
            inside = (ky >= 0) & (ky <= h - 1) & (kx >= 0) & (kx <= w - 1)
            cy = torch.where(inside, ky * scale, 0.0)
            cx = torch.where(inside, kx * scale, 0.0)
            cmap = torch.stack([torch.sum(wts * cx, -1), torch.sum(wts * cy, -1)], -1)
            coord = bilinear_sample(cmap[None], (coord / float(scale))[None])[0]
            rows.append(coord)
        return torch.stack(rows)

    @torch.no_grad()
    def track_points_forward(self, video: np.ndarray,
                             query_points: np.ndarray) -> Dict[str, np.ndarray]:
        """Forward-warp tracking of (P, 3) (t, x, y) query points, each group
        from its query frame (forward_coords); trajectories (T, P, 2), 0
        before a point's query frame; visibilities all False."""
        T, H, W, _ = video.shape
        feats = self.extract_features(video)
        qt = query_points[:, 0].astype(np.int64)
        traj = np.zeros((T, query_points.shape[0], 2), dtype=np.float32)
        for t in np.unique(qt):
            sel = np.nonzero(qt == t)[0]
            pts = torch.from_numpy(
                np.ascontiguousarray(query_points[sel, 1:], dtype=np.float32)).to(self.device)
            traj[int(t):, sel] = self.forward_coords(feats[int(t):], pts, (H, W)).cpu().numpy()
        return {"trajectories": traj, "visibilities": np.zeros((T, len(qt)), dtype=bool)}

    # ------------------------------------------------------------------ #
    # JHMDB / BADJA keypoint heatmap protocol
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def track_heatmaps_dispatch(
        self,
        video: np.ndarray,           # (T, H, W, 3) uint8 RGB
        ref_maps: np.ndarray,        # (h0, w0, P) reference keypoint heatmaps
        decode_hw: Tuple[int, int],  # the resolution coordinates decode at
        feats: Optional[torch.Tensor] = None,
    ) -> Dict:
        """Queue heatmap propagation on the device (square window: K1, or K4
        with spatial devices); `track_heatmaps_collect` reads the
        coordinates."""
        bank, (h, w) = self.video_bank(video, feats)
        del feats  # the bank holds every frame
        maps = torch.from_numpy(np.ascontiguousarray(ref_maps, np.float32)).to(self.device)
        propagate = self.propagate if self.spatial_devices is None else self.propagate_sp
        emit = lambda seg: self.decode(seg, tuple(decode_hw))[:, :2]  # noqa: E731
        rows = propagate(bank, 0, video.shape[0], resize_maps(maps, (h, w)).contiguous(), emit,
                         mask_shape="square")
        # frame 0 decodes the reference maps themselves at decode_hw
        ref_up = resize_maps(maps, tuple(decode_hw)).permute(2, 0, 1)
        return {"coords": [soft_argmax_topk(ref_up, topk=5), *rows]}

    def track_heatmaps_collect(self, disp: Dict) -> np.ndarray:
        """(T, P, 2) (x, y) at decode_hw."""
        return torch.stack(disp["coords"]).cpu().numpy()

    def track_heatmaps(
        self, video: np.ndarray, ref_maps: np.ndarray, decode_hw: Tuple[int, int],
        feats: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """Propagate reference heatmaps from frame 0 (the JAX
        track_heatmaps): the maps bilinear-resized to feature resolution
        (antialiased, as jax.image.resize), propagated with the square
        window, each frame decoded by upsampling to decode_hw and a top-5
        soft-argmax; frame 0 is the soft-argmax of the reference maps
        resized to decode_hw.  Returns (T, P, 2) (x, y)."""
        return self.track_heatmaps_collect(
            self.track_heatmaps_dispatch(video, ref_maps, decode_hw, feats=feats)
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
            f0 = self._extract(video[:1])[0]   # frame 0 at batch 1, RGB
            h, w = f0.shape[:2]
        else:
            bank, (h, w) = self.video_bank(video)
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
