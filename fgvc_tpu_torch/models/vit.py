"""Vision Transformer encoders of the zoo (fgvc_tpu/models/vit.py), NCHW in
and out: (N, 3, H, W) -> (N, dim, H / patch, W / patch) patch-token features.

* ``VisionTransformer`` (``vit_small_d8``): patch embedding, fixed sine/cosine
  positions and pre-norm blocks with flax's defaults, which are not
  PyTorch's: LayerNorm epsilon 1e-6, the tanh GELU, and
  MultiHeadDotProductAttention's separate query, key, value and output
  projections, with the query divided by sqrt(head_dim) before the product.
* ``DinoVisionTransformer`` (``dino_vit_small``, ``dino_vit_base``): the
  DINO release's ViT, named as its checkpoints are (``patch_embed.proj``,
  ``cls_token``, ``pos_embed``, ``blocks.{i}.attn.qkv`` ...), so that a
  strict load takes a released ``.pth`` once ``head.*`` and the ``module.``
  and ``backbone.`` prefixes are dropped (models/zoo.py).  LayerNorm epsilon
  1e-5, exact GELU, a class token, and learned positions on a
  ``pos_grid``-square grid, resized to the feature grid where it differs
  (ops/misc.resize_bicubic).

The attention runs in float32 in bounded pieces (ops/attention.softmax_attention).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fgvc_tpu_torch.ops.attention import softmax_attention
from fgvc_tpu_torch.ops.misc import resize_bicubic, sincos_embedding_2d


def patch_grid(x: torch.Tensor, patch: int):
    """(h, w) of the patch grid; an input that the patch does not divide is
    refused, as the JAX module's reshape refuses it."""
    H, W = x.shape[-2:]
    if H % patch or W % patch:
        raise ValueError(f"input {H}x{W} is not a multiple of the patch {patch}")
    return H // patch, W // patch


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, D) -> (B * heads, N, D / heads)."""
    B, N, D = x.shape
    return x.reshape(B, N, heads, D // heads).transpose(1, 2).reshape(B * heads, N, D // heads)


def merge_heads(y: torch.Tensor, B: int) -> torch.Tensor:
    """(B * heads, N, d) -> (B, N, heads * d)."""
    G, N, d = y.shape
    return y.reshape(B, G // B, N, d).transpose(1, 2).reshape(B, N, (G // B) * d)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden_ratio: int = 4, approximate: str = "tanh"):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * hidden_ratio)
        self.fc2 = nn.Linear(dim * hidden_ratio, dim)
        self.approximate = approximate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class MultiHeadAttention(nn.Module):
    """flax MultiHeadDotProductAttention (self-attention): query, key and
    value projections dim -> (heads, head_dim), output (heads, head_dim) -> dim."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(f(x), self.heads) for f in (self.query, self.key, self.value))
        return self.out(merge_heads(softmax_attention(q, k, v, scale_query=True), x.shape[0]))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiHeadAttention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MlpBlock(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class VisionTransformer(nn.Module):
    """Dense-feature ViT: patch embedding + sincos positions + blocks."""

    def __init__(self, patch: int = 8, dim: int = 256, depth: int = 6, heads: int = 8):
        super().__init__()
        self.patch, self.dim = patch, dim
        self.patch_embed = nn.Conv2d(3, dim, patch, patch)
        self.blocks = nn.ModuleList(TransformerBlock(dim, heads) for _ in range(depth))
        self.ln = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h, w = patch_grid(x, self.patch)
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, h * w, dim)
        x = x + sincos_embedding_2d(self.dim, h, w, x.device).reshape(1, h * w, self.dim)
        for blk in self.blocks:
            x = blk(x)
        return self.ln(x).transpose(1, 2).reshape(B, self.dim, h, w)


def vit_small_d8() -> VisionTransformer:
    """Stride-8 ViT comparable to the reference's DINO-S/8 ablations."""
    return VisionTransformer(patch=8, dim=384, depth=12, heads=6)


class DinoAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, D)
        q, k, v = (split_heads(qkv[:, :, i], self.heads) for i in range(3))
        return self.proj(merge_heads(softmax_attention(q, k, v, scale_query=False), B))


class DinoBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = DinoAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MlpBlock(dim, mlp_ratio, approximate="none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class DinoVisionTransformer(nn.Module):
    """DINO ViT: class token, learned positions and pre-norm blocks; returns
    the patch tokens after the last LayerNorm."""

    def __init__(self, patch: int = 8, dim: int = 384, depth: int = 12, heads: int = 6,
                 pos_grid: int = 28):
        super().__init__()
        self.patch, self.dim, self.pos_grid = patch, dim, pos_grid
        self.patch_embed = PatchEmbed(dim, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, dim))
        self.blocks = nn.ModuleList(DinoBlock(dim, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h, w = patch_grid(x, self.patch)
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)  # (B, h * w, dim)
        cls_pos, grid_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        g = grid_pos.reshape(1, self.pos_grid, self.pos_grid, self.dim).permute(0, 3, 1, 2)
        grid_pos = resize_bicubic(g, (h, w)).permute(0, 2, 3, 1).reshape(1, h * w, self.dim)
        x = torch.cat([(self.cls_token + cls_pos).expand(B, 1, self.dim), x + grid_pos], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1:].transpose(1, 2).reshape(B, self.dim, h, w)


def dino_vit_small(patch: int = 8) -> DinoVisionTransformer:
    return DinoVisionTransformer(patch=patch, dim=384, depth=12, heads=6, pos_grid=224 // patch)


def dino_vit_base(patch: int = 8) -> DinoVisionTransformer:
    return DinoVisionTransformer(patch=patch, dim=768, depth=12, heads=12, pos_grid=224 // patch)
