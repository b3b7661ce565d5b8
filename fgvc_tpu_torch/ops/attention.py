"""L2 normalisation and the halo-padded key bank (fgvc_tpu/ops/attention.py),
and the zoo encoders' softmax attention in bounded pieces."""

from __future__ import annotations

import math
from typing import Optional

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), torch.nn.functional.normalize semantics."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def build_padded_bank(
    bank: torch.Tensor,   # (Tb, H, W, C)
    *,
    halo: int,
    rows_total: int,
    cols_total: int,
    normalize: bool = True,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(Tb, rows_total, cols_total, C) zeros with each frame, normalised,
    written at spatial offset (halo, halo), in `dtype` (the bank's own by
    default).

    Frames are normalised in the bank's dtype and then cast (round to
    nearest even for bfloat16), one at a time into the output, so no full
    normalised copy of the bank exists next to it."""
    Tb, H, W, C = bank.shape
    out = torch.zeros(
        (Tb, rows_total, cols_total, C),
        dtype=bank.dtype if dtype is None else dtype,
        device=bank.device,
    )
    for t in range(Tb):
        f = l2_normalize(bank[t]) if normalize else bank[t]
        out[t, halo : halo + H, halo : halo + W] = f.to(out.dtype)
    return out


# score elements a piece of softmax_attention may hold: 1 GiB of float32
SCORE_BUDGET = 1 << 28


def softmax_attention(
    q: torch.Tensor,   # (G, N, d): G = batch x heads
    k: torch.Tensor,   # (G, M, d)
    v: torch.Tensor,   # (G, M, dv)
    *,
    scale_query: bool,
    budget: int = SCORE_BUDGET,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v in float32, computed in pieces of heads
    and query rows whose score matrices hold at most `budget` elements
    (DINO-B/8 at 480 x 880 has 6,601 tokens: 174 MB of scores per head),
    with the same product and softmax in every piece.  `scale_query`
    divides q by sqrt(d) before the product (flax's
    MultiHeadDotProductAttention), else the scores after it (DINO's)."""
    G, N, d = q.shape
    M = k.shape[1]
    sqrt_d = math.sqrt(d)
    rows = max(1, min(N, budget // M))
    groups = max(1, min(G, budget // (rows * M)))
    out = q.new_empty((G, N, v.shape[-1]))
    for g0 in range(0, G, groups):
        kt = k[g0 : g0 + groups].transpose(1, 2)
        for r0 in range(0, N, rows):
            qs = q[g0 : g0 + groups, r0 : r0 + rows]
            a = (qs / sqrt_d) @ kt if scale_query else (qs @ kt) / sqrt_d
            out[g0 : g0 + groups, r0 : r0 + rows] = torch.softmax(a, dim=-1) @ v[g0 : g0 + groups]
    return out
