"""More encoders of the zoo (fgvc_tpu/models/backbones_extra.py), NCHW in and
out:

* ``ResNet18MAST``: MAST's encoder, a 7x7/2 stem and four stages of two
  residual blocks, all at stride 1: stride-2 features at 256 channels.
* ``SwinTransformer`` (``swin_tiny``): shifted-window attention with a
  relative-position bias and patch merging, with the JAX module's rules:
  each stage's window is clamped to its map and the shift is off where the
  map is no larger than one window; the bias table is sized to the clamped
  window, so the module is built for one input size (`input_hw`); the
  shift mask is -1e9; the MLP's GELU is the tanh one; LayerNorm epsilon
  1e-6.  The JAX module runs every stage whatever `out_indices` says, and
  fails where a stage's map is not a multiple of its window or a merge
  meets an odd size: here those sizes raise ValueError, at construction and
  at each call, naming the stage, its map and its window.  Stages past the
  last output are checked but not computed.
* ``ResNet18Pos``: a stem, a learned absolute position grid
  (``pos_grid`` square, 64 channels, resized to the stem's map as
  ops/misc.resize_bicubic does) and three stages (64, 128, 256) at strides
  (1, 2, 1): the reference's forward returns layer3 (its layer4 is defined
  but commented out), and so does this.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fgvc_tpu_torch.ops.misc import resize_bicubic


class MastResidualBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.short_conv = self.short_bn = None
        if stride != 1 or inplanes != planes:
            self.short_conv = nn.Conv2d(inplanes, planes, 1, stride, bias=False)
            self.short_bn = nn.BatchNorm2d(planes, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.short_conv is not None:
            x = self.short_bn(self.short_conv(x))
        return torch.relu(x + y)


def _stages(plan: Sequence[Tuple[int, int, int]]) -> Tuple[nn.ModuleList, ...]:
    """layer1.. of MastResidualBlocks from (planes, stride, blocks) each."""
    layers, cin = [], 64
    for planes, stride, blocks in plan:
        mods = []
        for b in range(blocks):
            mods.append(MastResidualBlock(cin, planes, stride if b == 0 else 1))
            cin = planes
        layers.append(nn.Sequential(*mods))
    return tuple(layers)


class ResNet18MAST(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = nn.BatchNorm2d(64, eps=1e-5)
        self.layer1, self.layer2, self.layer3, self.layer4 = _stages(
            [(64, 1, 2), (128, 1, 2), (256, 1, 2), (256, 1, 2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem_bn(self.stem_conv(x)))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class ResNet18Pos(nn.Module):
    def __init__(self, pos_grid: int = 128, use_ape: bool = True):
        super().__init__()
        self.use_ape = use_ape
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        # (1, grid, grid, 64), the JAX parameter's layout
        self.pos_embed1 = nn.Parameter(torch.zeros(1, pos_grid, pos_grid, 64))
        self.layer1, self.layer2, self.layer3 = _stages([(64, 1, 2), (128, 2, 2), (256, 1, 2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        if self.use_ape:
            x = x + resize_bicubic(self.pos_embed1.permute(0, 3, 1, 2), tuple(x.shape[-2:]))
        return self.layer3(self.layer2(self.layer1(x)))


# --------------------------------------------------------------------- #
# Swin Transformer (channels-last inside)
# --------------------------------------------------------------------- #
def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(w: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = w.shape[0] // (H // ws * W // ws)
    x = w.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def clamped_window(window: int, shift: int, h: int, w: int) -> Tuple[int, int]:
    """(window, shift) of a block on an h x w map: the window clamped to the
    map, the shift off where the map is no larger than one window."""
    ws = min(window, h, w)
    return ws, (shift if min(h, w) > ws else 0)


def swin_stage_maps(input_hw: Tuple[int, int], patch: int, window: int,
                    n_stages: int) -> List[Tuple[int, int, int]]:
    """(h, w, clamped window) of each stage for an input size; raises
    ValueError where the JAX module fails: a map that is not a multiple of
    its window, or an odd map before a merge."""
    H, W = input_hw
    h, w = -(-H // patch), -(-W // patch)  # the patch embedding's 'SAME' padding
    maps = []
    for si in range(n_stages):
        ws = min(window, h, w)
        if h % ws or w % ws:
            raise ValueError(
                f"swin stage {si} at {h}x{w} (input {H}x{W}) is not a multiple of its "
                f"window {ws}: the JAX module fails here too")
        maps.append((h, w, ws))
        if si < n_stages - 1:
            if h % 2 or w % 2:
                raise ValueError(
                    f"swin patch merging after stage {si} meets the odd map {h}x{w} "
                    f"(input {H}x{W}): the JAX module fails here too")
            h, w = h // 2, w // 2
    return maps


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        ar = torch.arange(window)
        coords = torch.stack(torch.meshgrid(ar, ar, indexing="ij"), -1).reshape(-1, 2)
        rel = coords[:, None] - coords[None, :] + (window - 1)
        self.register_buffer("relative_position_index",
                             rel[..., 0] * (2 * window - 1) + rel[..., 1], persistent=False)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        """x: (nW, ws^2, C); attn_mask: (n_mask, ws^2, ws^2) additive or None."""
        N, L, C = x.shape
        hd = C // self.heads
        qkv = self.qkv(x).reshape(N, L, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (N, heads, L, hd)
        a = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        bias = self.relative_position_bias_table[self.relative_position_index]  # (L, L, heads)
        a = a + bias.permute(2, 0, 1)[None]
        if attn_mask is not None:
            n_mask = attn_mask.shape[0]
            a = (a.reshape(-1, n_mask, self.heads, L, L) + attn_mask[None, :, None]).reshape(
                N, self.heads, L, L)
        y = (torch.softmax(a, dim=-1) @ v).transpose(1, 2).reshape(N, L, C)
        return self.proj(y)


class SwinMlp(nn.Module):
    def __init__(self, dim: int, ratio: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwinBlock(nn.Module):
    """One block: `window` and `shift` are the nominal ones, clamped to the
    map at each call; the bias table is sized to `table_window`, the window
    clamped to the map the module was built for."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, table_window: int,
                 mlp_ratio: int = 4):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(dim, heads, table_window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = SwinMlp(dim, mlp_ratio)

    @staticmethod
    def shift_mask(H: int, W: int, ws: int, s: int, device) -> torch.Tensor:
        """Additive mask against attention across the rolled border."""
        img = torch.zeros((H, W), dtype=torch.int32, device=device)
        cnt = 0
        for hs in (slice(0, -ws), slice(-ws, -s), slice(-s, None)):
            for wsl in (slice(0, -ws), slice(-ws, -s), slice(-s, None)):
                img[hs, wsl] = cnt
                cnt += 1
        mw = window_partition(img[None, :, :, None], ws)[..., 0]
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return torch.where(mw[:, :, None] == mw[:, None, :], zero, zero - 1e9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C)."""
        B, H, W, C = x.shape
        ws, s = clamped_window(self.window, self.shift, H, W)
        y = self.norm1(x)
        mask = None
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            mask = self.shift_mask(H, W, ws, s, x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, H, W)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2 x 2 neighbours concatenated (row offset, then column), LayerNorm,
    and a bias-free linear map to twice the channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-6)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))


class SwinStage(nn.Module):
    def __init__(self, blocks: Sequence[SwinBlock], downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Swin for inputs of `input_hw`; returns the features of the stages in
    `out_indices` (stride patch * 2^stage)."""

    def __init__(self, patch: int = 4, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 out_indices: Tuple[int, ...] = (-1,),
                 input_hw: Tuple[int, int] = (224, 224)):
        super().__init__()
        self.patch, self.window, self.depths = patch, window, tuple(depths)
        self.input_hw = tuple(input_hw)
        n = len(self.depths)
        self.out_indices = tuple(i % n for i in out_indices)
        maps = swin_stage_maps(self.input_hw, patch, window, n)
        self.patch_embed = nn.Conv2d(3, embed_dim, patch, patch)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=1e-6)
        stages, dim = [], embed_dim
        for si, depth in enumerate(self.depths):
            h, w, _ = maps[si]
            blocks = [SwinBlock(dim, heads[si], window, 0 if bi % 2 == 0 else window // 2,
                                min(window, h, w)) for bi in range(depth)]
            stages.append(SwinStage(blocks, PatchMerging(dim) if si < n - 1 else None))
            dim *= 2 if si < n - 1 else 1
        self.layers = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor):
        H, W = x.shape[-2:]
        maps = swin_stage_maps((H, W), self.patch, self.window, len(self.depths))
        for si, (stage, (_, _, ws)) in enumerate(zip(self.layers, maps)):
            if ws != stage.blocks[0].attn.window:
                raise ValueError(
                    f"swin stage {si}: an input of {H}x{W} clamps the window to {ws}, but "
                    f"this module was built for {self.input_hw} (window "
                    f"{stage.blocks[0].attn.window}); the JAX module fails here too")
        p = self.patch
        ph, pw = (-H) % p, (-W) % p  # 'SAME' padding
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        outs = {}
        for si, stage in enumerate(self.layers[: max(self.out_indices) + 1]):
            for blk in stage.blocks:
                x = blk(x)
            outs[si] = x
            if stage.downsample is not None:
                x = stage.downsample(x)
        sel = [outs[i].permute(0, 3, 1, 2).contiguous() for i in self.out_indices]
        return sel[0] if len(sel) == 1 else tuple(sel)


def swin_tiny(**kw) -> SwinTransformer:
    return SwinTransformer(**kw)
