"""The mixed training objective (fgvc_tpu/models/mixed_tracker.py):
self-supervised reconstruction, flow-supervised correlation distillation
and adversarial alignment of correlation volumes.

  (i)   reconstruction: one Lab chroma channel is dropped from both frames,
        the student's radius-R local correlation between the two frames'
        features is softmaxed and reconstructs the target frame's dropped
        channel from the reference frame's pixels;
  (ii)  distillation on synthetic pairs with ground-truth flow: the frozen
        teacher's flow-warped self-correlation (over 0.07) is the soft target
        of the student's cross-frame correlation, a soft cross entropy on
        flow-valid, non-occluded pixels;
  (iii) a gradient-reversal MLP discriminator tells the synthetic (source)
        correlation volumes from the unlabeled (target) ones, by BCE.

Feature maps are channels-last, (B, h, w, C), as in the JAX package.  The
reference's quirks stay: the teacher's features are L2-normalised along the
height axis (F.normalize(f, dim=2) on NCHW), the occlusion test keeps
``flow_fw * 2``, and one dropped channel serves the whole batch.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from fgvc_tpu_torch.config import TrainConfig
from fgvc_tpu_torch.ops.attention import l2_normalize
from fgvc_tpu_torch.ops.gradient_reversal import gradient_reversal
from fgvc_tpu_torch.ops.local_corr import extract_displacement_windows, local_correlation
from fgvc_tpu_torch.ops.warp import bilinear_sample, forward_backward_consistency
from fgvc_tpu_torch.parallel.dist import all_sum, process_info


class GradReverseDiscriminator(nn.Module):
    """Gradient reversal, then Linear feat_dim -> feat_dim/2 -> feat_dim/4
    -> 1 with ReLUs between.  models/resnet.init_flax_like draws its weights
    as flax's Dense does (lecun-normal, zero bias)."""

    def __init__(self, feat_dim: int, alpha: float = 1.0):
        super().__init__()
        self.alpha = alpha
        self.fc1 = nn.Linear(feat_dim, feat_dim // 2)
        self.fc2 = nn.Linear(feat_dim // 2, feat_dim // 4)
        self.fc3 = nn.Linear(feat_dim // 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gradient_reversal(x, self.alpha)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.fc3(x)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def soft_ce(pred_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Per-row soft cross entropy: -sum softmax(target) * log_softmax(pred)."""
    logp = torch.log_softmax(pred_logits, dim=-1)
    q = torch.softmax(target_logits, dim=-1)
    return -torch.sum(q * logp, dim=-1)


def drop_channel(frames: torch.Tensor, ch: int) -> torch.Tensor:
    """Zero Lab channel `ch` of (..., 3) frames and scale the rest by 1.5."""
    mask = torch.ones(3, dtype=frames.dtype, device=frames.device)
    mask[ch] = 0.0
    return frames * mask * (3.0 / 2.0)


def drop_lab_channel(frames: torch.Tensor, generator: torch.Generator) -> Tuple[torch.Tensor, int]:
    """Drop one chroma channel, 1 or 2, drawn from `generator`, on every
    frame of the batch (the reference's dropout2d_lab); (dropped, ch)."""
    ch = int(torch.randint(1, 3, (), generator=generator))
    return drop_channel(frames, ch), ch


def _linear_weights(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) bilinear weights with half-pixel centres, the source
    position clamped to the first and last pixel."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5).clamp(0, n_in - 1)
    i0 = src.floor().long()
    i1 = (i0 + 1).clamp(max=n_in - 1)
    frac = src - i0
    w = torch.zeros((n_out, n_in), dtype=torch.float64)
    rows = torch.arange(n_out)
    w.index_put_((rows, i0), 1.0 - frac, accumulate=True)
    w.index_put_((rows, i1), frac, accumulate=True)
    return w.to(device=like.device, dtype=like.dtype)


def upsample_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C) for H >= h, W >= w: bilinear with
    half-pixel centres and the border pixels held, what
    jax.image.resize(..., 'bilinear') gives when it enlarges (its weights
    renormalised at the edges).  Two products with the weight matrices:
    their backward is deterministic on the card, where F.interpolate's
    accumulates with atomics."""
    wh = _linear_weights(x.shape[1], size[0], x)
    ww = _linear_weights(x.shape[2], size[1], x)
    return torch.einsum("Hh,bhwc,Ww->bHWc", wh, x, ww)


def _corr(tar, ref, cfg: TrainConfig) -> torch.Tensor:
    """(B, h, w, (2R+1)^2) local correlation of tar against ref."""
    c = local_correlation(tar, ref, cfg.radius, precision=cfg.matmul_precision)
    return c.reshape(*c.shape[:3], -1)


def reconstruction_loss(
    feats_pair: torch.Tensor,   # (B, 2, h, w, C) raw student features
    clean_pair: torch.Tensor,   # (B, 2, H, W, 3) clean Lab-normalised frames
    ch: int,                    # the dropped channel
    cfg: TrainConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MAST reconstruction: (loss, raw correlation volume (B, h, w, win^2)),
    the volume reused as the adversarial branch's target domain."""
    C = feats_pair.shape[-1]
    corr = _corr(feats_pair[:, 1], feats_pair[:, 0], cfg)
    att = torch.softmax(corr / math.sqrt(C), dim=-1)
    d = cfg.downsample_rate
    ref_small = clean_pair[:, 0, ::d, ::d, ch:ch + 1]  # (B, h, w, 1)
    windows = extract_displacement_windows(ref_small, cfg.radius)
    windows = windows.reshape(*att.shape)
    recon = torch.sum(att * windows, dim=-1, keepdim=True)  # (B, h, w, 1)
    recon_up = upsample_bilinear(recon, tuple(clean_pair.shape[2:4]))
    tar_gt = clean_pair[:, 1, ..., ch:ch + 1]
    loss = torch.mean(smooth_l1(recon_up * cfg.rec_weight, tar_gt * cfg.rec_weight))
    return loss, corr


def supervised_distillation_loss(
    student_pair: torch.Tensor,  # (B, 2, h, w, C) raw student features (sup)
    teacher_feat: torch.Tensor,  # (B, h, w, C) teacher features of clean frame 0
    flow: torch.Tensor,          # (B, H, W, 2) frame1 -> frame0 flow (full res)
    flow_back: torch.Tensor,     # (B, H, W, 2)
    cfg: TrainConfig,
) -> torch.Tensor:
    """Soft CE between the student's cross-frame correlation and the
    teacher's warped self-correlation, on valid pixels.  The mean is over
    the valid pixels of the whole batch, a ratio, so under a process group
    of several processes the count is summed over them and this process returns its
    share world * sum_r / max(count, 1): the mean of the shares over the
    processes is the global batch's loss, and so is that of their
    gradients."""
    B, _, h, w, _ = student_pair.shape
    R, s = cfg.radius, cfg.scale
    with torch.no_grad():
        tf = l2_normalize(teacher_feat, dim=1)  # the height axis: the quirk
        occ_s = forward_backward_consistency(flow, flow_back)[:, ::s, ::s]
        flow_s = flow[:, ::s, ::s] / float(cfg.downsample_rate)  # feature units
        flow_d = flow_s + R
        valid = ((flow_d[..., 0] >= 0) & (flow_d[..., 0] <= 2 * R)
                 & (flow_d[..., 1] >= 0) & (flow_d[..., 1] <= 2 * R)
                 & occ_s.bool())
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=flow.device),
            torch.arange(w, dtype=torch.float32, device=flow.device),
            indexing="ij",
        )
        coords = torch.stack([gx + flow_s[..., 0], gy + flow_s[..., 1]], dim=-1)
        warp_tf = bilinear_sample(tf, coords)
        target = _corr(warp_tf, tf, cfg) / cfg.temperature_t
    sn = l2_normalize(student_pair, dim=-1)
    pred = _corr(sn[:, 1], sn[:, 0], cfg) / cfg.temperature_t
    win2 = pred.shape[-1]
    ce = soft_ce(pred.reshape(-1, win2), target.reshape(-1, win2))
    wmask = valid.reshape(-1).to(torch.float32)
    total, count = torch.sum(ce * wmask), torch.sum(wmask)
    world = process_info()[1]
    if world > 1:
        total, count = total * world, all_sum(count)
    return total / torch.clamp_min(count, 1.0)


def adversarial_corr_loss(
    disc: nn.Module,
    corr_source: torch.Tensor,  # (B, h, w, win^2) synthetic-domain volume
    corr_target: torch.Tensor,  # (B, h, w, win^2) real-domain volume
) -> torch.Tensor:
    """BCE on per-pixel correlation volumes through the gradient-reversal
    discriminator: source label 0, target label 1."""
    win2 = corr_source.shape[-1]
    src = disc(corr_source.reshape(-1, win2))[:, 0]
    tgt = disc(corr_target.reshape(-1, win2))[:, 0]
    logits = torch.cat([src, tgt])
    labels = torch.cat([torch.zeros_like(src), torch.ones_like(tgt)])
    loss = torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    return torch.mean(loss)


def corr_source_volume(feats_sup: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """The adversarial branch's source-domain volume: the raw correlation of
    the synthetic pair's student features."""
    return _corr(feats_sup[:, 1], feats_sup[:, 0], cfg)
