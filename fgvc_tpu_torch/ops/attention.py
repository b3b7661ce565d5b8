"""L2 normalisation, the halo-padded key bank and the chunked ('dense')
radius-masked top-k attention (fgvc_tpu/ops/attention.py), the affinity
products in the precision modes, and the zoo encoders' softmax attention in
bounded pieces.

Precision modes of the affinity products (`affinity`), as the port's
ops/local_corr.py keeps them: 'highest' float32 (TF32 off,
device.set_matmul_precision), 'high' bf16x3 (the three products hi.hi +
hi.lo + lo.hi of the operands' bf16 halves, as one product of the halves
concatenated along C), 'default' one bf16 product; float32 sums in every
mode, on the tensor cores for bf16 operands on the card.  The value mix after
the top-k runs in float32 in every mode: k terms a query pixel, as XLA
computes it off the TPU.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from fgvc_tpu_torch.config import MATMUL_PRECISIONS
from fgvc_tpu_torch.ops.local_corr import _parts
from fgvc_tpu_torch.ops.topk import top_k

NINF = float("-inf")


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


def operand(x: torch.Tensor, precision: str, side: str) -> torch.Tensor:
    """x (..., n, C) as one side ('q' or 'k') of an affinity product in
    `precision`: itself in 'highest', bf16(x) in 'default', its bf16 halves
    concatenated along C in 'high' (q as hi, hi, lo; k as hi, lo, hi).  bf16
    on the card; their float32 values on the CPU, where a float32 product of
    bf16 values is exact per term."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"precision must be one of {MATMUL_PRECISIONS}, got {precision!r}")
    return _parts(x, precision, x.dim() - 1, "hhl" if side == "q" else "hlh")


def affinity(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(..., S, C') x (..., K, C')^T -> (..., S, K) float32 of two operand()s
    (2-D, or 3-D batched)."""
    kt = k.transpose(-1, -2)
    if q.dtype == torch.bfloat16:
        return (torch.mm if q.dim() == 2 else torch.bmm)(q, kt, out_dtype=torch.float32)
    return q @ kt


def frame_mask(key_valid: Optional[Sequence[bool]], T: int):
    """key_valid as Python bools (all True where None): the propagation loops
    pass lists, so masking a slot never copies from the device."""
    return [True] * T if key_valid is None else [bool(v) for v in key_valid]


def mix_topk(aff: torch.Tensor, v: torch.Tensor, topk: int, mode: str) -> torch.Tensor:
    """The top-k value mix of (..., S, K) affinities over (..., K, Cv) values
    (a batch axis or none): lax.top_k's members, softmaxed ('softmax') or
    clamp(min=0)^2 ('cosine'), weight the gathered values in float32."""
    w, idx = top_k(aff, topk)
    w = torch.softmax(w, dim=-1) if mode == "softmax" else torch.clamp_min(w, 0.0) ** 2
    lead = aff.shape[:-2]
    S, Cv = aff.shape[-2], v.shape[-1]
    vals = torch.gather(v, -2, idx.reshape(*lead, S * topk, 1).expand(*lead, S * topk, Cv))
    vals = vals.reshape(*lead, S, topk, Cv)
    return (w[..., None, :] @ vals)[..., 0, :]


def mix_all(aff: torch.Tensor, v: torch.Tensor, mode: str) -> torch.Tensor:
    """topk None: every affinity weights the values (softmax or cosine)."""
    w = torch.softmax(aff, dim=-1) if mode == "softmax" else torch.clamp_min(aff, 0.0) ** 2
    return w @ v


def spatial_neighbor_mask(height: int, width: int, neighbor_range: int,
                          device=None) -> torch.Tensor:
    """(H*W, H*W) bool circle mask: key pixel i neighbours query pixel j
    where their grid distance is strictly below neighbor_range // 2."""
    radius = neighbor_range // 2
    gy, gx = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    gy, gx = gy.reshape(-1).float(), gx.reshape(-1).float()
    d = torch.sqrt((gy[:, None] - gy[None, :]) ** 2 + (gx[:, None] - gx[None, :]) ** 2)
    return d < radius


def masked_topk_attention(
    query: torch.Tensor,   # (H, W, C)
    key: torch.Tensor,     # (T, H, W, C)
    value: torch.Tensor,   # (T, H, W, Cv)
    *,
    radius: Optional[float],
    temperature: float = 1.0,
    topk: Optional[int] = None,
    normalize: bool = True,
    step: int = 512,
    non_mask_len: int = 0,
    mode: str = "softmax",
    mask_shape: str = "circle",
    key_valid: Optional[Sequence[bool]] = None,
    precision: str = "highest",
    sim_mode: str = "dot_product",
) -> torch.Tensor:
    """attention_impl 'dense': (H, W, Cv) propagated values.  Query pixels
    in chunks of `step` each form their affinities to the key pixels of the
    rows within the radius (at most (step, T*H*W); no (T*H*W x H*W) volume),
    masked to the radius ('circle':
    grid distance < radius; 'square': |dy|, |dx| <= radius; radius None: no
    spatial mask) except on the `non_mask_len` leading key frames, and to
    the valid slots; the top-k (or all, topk None) mix the values.
    sim_mode 'dot_product' divides by temperature, 'l2-distance' takes
    (2 k.q - |k|^2) / sqrt(C)."""
    if mode not in ("softmax", "cosine"):
        raise ValueError(f"unknown mode {mode}")
    H, W, C = query.shape
    T, Cv, HW = key.shape[0], value.shape[-1], H * W
    if normalize:
        query, key = l2_normalize(query), l2_normalize(key)
    q = operand(query.reshape(HW, C), precision, "q")
    k3 = operand(key.reshape(T, HW, C), precision, "k")
    v3 = value.reshape(T, HW, Cv)
    k_sq = torch.sum(key * key, dim=-1).reshape(T, HW) if sim_mode == "l2-distance" else None
    valid = frame_mask(key_valid, T)
    dev = query.device
    gy = torch.arange(H, device=dev, dtype=torch.float32).repeat_interleave(W)
    gx = torch.arange(W, device=dev, dtype=torch.float32).repeat(H)
    out = value.new_empty((HW, Cv), dtype=torch.float32)
    for c0 in range(0, HW, step):
        c1 = min(HW, c0 + step)
        # the key pixels the chunk can reach: the rows within the radius of
        # its rows (all of them on the non_mask_len leading frames).  The
        # columns left out are -inf in every row, and the ones kept keep
        # their order, so the top-k members and the mix are the same.
        lo, hi = 0, HW
        if radius is not None:
            reach = int(radius) + 1
            lo, hi = max(0, c0 // W - reach) * W, min(H, (c1 - 1) // W + reach + 1) * W
        spans = [(0, HW) if t < non_mask_len else (lo, hi) for t in range(T)]
        if topk is not None and sum(b - a for a, b in spans) < topk:
            spans = [(0, HW)] * T
        ab = affinity(q[c0:c1], torch.cat([k3[t, a:b] for t, (a, b) in enumerate(spans)]))
        if k_sq is not None:
            k_sq_c = torch.cat([k_sq[t, a:b] for t, (a, b) in enumerate(spans)])
            aff = (2.0 * ab - k_sq_c[None, :]) / math.sqrt(C)
        else:
            aff = ab / temperature
        if radius is not None:
            dy = (gy[c0:c1, None] - gy[None, lo:hi]).abs()
            dx = (gx[c0:c1, None] - gx[None, lo:hi]).abs()
            if mask_shape == "circle":
                outside = ~(dy * dy + dx * dx < radius * radius)
            else:
                outside = ~((dy <= radius) & (dx <= radius))
        off = 0
        for t, (a, b) in enumerate(spans):
            cols = aff[:, off:off + b - a]
            if not valid[t]:
                cols.fill_(NINF)
            elif radius is not None and t >= non_mask_len:
                cols.masked_fill_(outside, NINF)
            off += b - a
        v = torch.cat([v3[t, a:b] for t, (a, b) in enumerate(spans)])
        out[c0:c1] = mix_topk(aff, v, topk, mode) if topk is not None else mix_all(aff, v, mode)
    return out.reshape(H, W, Cv)


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


def non_local_attention(
    query: torch.Tensor,   # (H, W, C)
    key: torch.Tensor,     # (H, W, C) or (T, H, W, C)
    temperature: float = 1.0,
    normalize: bool = True,
    softmax_axis: int = -1,
) -> torch.Tensor:
    """Global frame-pair affinity of the correspondence demo
    (fgvc_tpu/ops/attention.py's non_local_attention): softmax(q . k / t)
    over `softmax_axis` between a query frame and one or more key frames,
    both L2-normalised along C where `normalize`; the (H*W, T*H*W) float32
    product with TF32 off (device.set_matmul_precision)."""
    H, W, C = query.shape
    if key.dim() == 3:
        key = key[None]
    q, k = query.float(), key.float()
    if normalize:
        q, k = l2_normalize(q), l2_normalize(k)
    aff = torch.matmul(q.reshape(-1, C), k.reshape(-1, C).t()) / temperature
    return torch.softmax(aff, dim=softmax_axis)
