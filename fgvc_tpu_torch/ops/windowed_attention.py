"""Tiled windowed top-k attention, attention_impl 'tiled'
(fgvc_tpu/ops/windowed_attention.py).

Queries are cut into tile x tile blocks; each block sees only the
(tile + 2 * halo)^2 key and value window around itself on each of the T key
slots, which holds every key that the radius mask allows, so the result
equals the 'dense' attention (ops/attention.py) with non_mask_len 0.  A
block's affinities are one (tile^2, C) x (C, T * win^2) product in the
precision's arithmetic (ops/attention.py `affinity`).

The blocks of one row of tiles run in one batched call, cut into pieces of
at most TILE_BUDGET affinity elements (at 256 x 256 input, radius 15, tile
32: 1024 x 23,064 float32, 94 MB a tile, so four tiles a piece); a row block
of spatial-parallel propagation has the same tile rows, so its pieces are
the unsharded call's and its rows equal them bit for bit.

Bank mode (`frame_idx` given): `key` is the whole video's bank, normalised
and halo-padded once by `pad_key_bank`, and each slot reads its frame's
windows from it.  Row-block mode (`row_offset`, `full_h`, `grid_rows`): the
query is the rows [row_offset, row_offset + H) of a grid of `full_h` rows;
block rows at or past `full_h` are garbage (NaN under softmax) and the
caller cuts them.

topk_impl (the top-k of mode 'softmax'):
  'exact'      lax.top_k's members (ops/topk.top_k), softmax, gathered
               values;
  'segmented'  the k-th value by topk_segmented (seg 512), then the
               thresholded value mix `gather_free_value_matmul`: every
               affinity above it weighs in, those at it share the remaining
               top-k budget equally;
  'certified'  max(32, 2k) candidates by jax.lax.approx_max_k, certified,
               then the same mix.  approx_max_k is exact off the TPU, so
               the candidates here are the exact top values and the
               certificate always holds;
  'approx'     the top-k values by approx_max_k (exact here too), every
               affinity at or above the k-th value weighted, no tie split.
Their TPU-only approximation (recall 0.95) has no counterpart on the card.

`masked_topk_attention_tiled_bank_sharded` runs bank mode over a bank cut
into frame shards on several devices (bank-parallel propagation).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from fgvc_tpu_torch.config import TOPK_IMPLS
from fgvc_tpu_torch.ops.attention import (
    NINF,
    affinity,
    build_padded_bank,
    frame_mask,
    l2_normalize,
    mix_all,
    mix_topk,
    operand,
)
from fgvc_tpu_torch.ops.topk import topk_segmented

TILE_BUDGET = 1 << 27  # affinity elements a batched call holds (512 MB of float32)


def gather_free_value_matmul(aff, w10, v):
    """Thresholded-softmax value mix without a gather: (..., S, K)
    affinities, (..., S, k) exact top-k values, (..., K, Cv) values.  Every
    affinity above the k-th value gets its softmax weight; those equal to
    it share the rest of the top-k budget (a frame in two slots ties with
    itself, and then this equals the exact top-k mix).  The clamps keep rows
    of -inf finite."""
    m = torch.clamp_min(w10.amax(-1, keepdim=True), -1e30)
    thresh = torch.clamp_min(w10.amin(-1, keepdim=True), -1e30)
    z = torch.exp(w10 - m).sum(-1, keepdim=True) + 1e-30
    at = (aff == thresh).float()
    n_at = at.sum(-1, keepdim=True)
    n_sel = (w10 == thresh).float().sum(-1, keepdim=True)
    tie_frac = torch.where(n_at > 0, n_sel / torch.clamp_min(n_at, 1.0), 0.0)
    weights = torch.exp(aff - m) * ((aff > thresh).float() + tie_frac * at) / z
    return weights @ v


def _approx_value_matmul(aff, w10, v):
    """topk_impl 'approx': every affinity at or above the k-th value
    weighted by its softmax weight over the top-k's normaliser."""
    m = torch.clamp_min(w10.amax(-1, keepdim=True), -1e30)
    thresh = torch.clamp_min(w10.amin(-1, keepdim=True), -1e30)
    z = torch.exp(w10 - m).sum(-1, keepdim=True) + 1e-30
    step = torch.clamp(torch.sign(aff - thresh) + 1.0, 0.0, 1.0)
    return (torch.exp(aff - m) * step / z) @ v


class TileGeometry:
    """The query tiles' geometry (fgvc_tpu's _TileGeometry): halo =
    int(radius), win = tile + 2 * halo, the query grid padded to (Hp, Wp),
    the key and value rows padded to `grid_rows` (the grid of `full_h` rows
    by default), and the radius window of a tile's pixels over its
    win x win key window."""

    def __init__(self, H, W, tile, radius, mask_shape, full_h=None, grid_rows=None,
                 device=None):
        self.H, self.W, self.tile, self.radius = H, W, tile, radius
        self.halo = int(radius)
        self.win = tile + 2 * self.halo
        self.S = tile * tile
        self.fullH = H if full_h is None else full_h
        self.Hp = -(-H // tile) * tile
        self.Wp = -(-W // tile) * tile
        self.gridH = -(-self.fullH // tile) * tile if grid_rows is None else grid_rows
        self.nth, self.ntw = self.Hp // tile, self.Wp // tile
        s = torch.arange(self.S, device=device)
        f = torch.arange(self.win * self.win, device=device)
        qi, qj = (s // tile).float(), (s % tile).float()
        self.ki, self.kj = (f // self.win).float(), (f % self.win).float()
        dy = (self.ki[None, :] - self.halo - qi[:, None]).abs()
        dx = (self.kj[None, :] - self.halo - qj[:, None]).abs()
        if mask_shape == "circle":
            self.mask = dy * dy + dx * dx < radius * radius     # (S, win^2)
        else:
            self.mask = (dy <= radius) & (dx <= radius)

    def pad_query(self, query):
        return F.pad(query, (0, 0, 0, self.Wp - self.W, 0, self.Hp - self.H))

    def pad_values(self, value):
        h = self.halo
        return F.pad(value, (0, 0, h, h + self.Wp - self.W, h, h + self.gridH - self.fullH))

    def allowed(self, tr, tc):
        """(N, S, win^2) bool: inside the radius window and the image, for
        N tiles whose global row and column origins are tr, tc (N,)."""
        kgi = tr[:, None] + self.ki[None] - self.halo
        kgj = tc[:, None] + self.kj[None] - self.halo
        inside = (kgi >= 0) & (kgi <= self.fullH - 1) & (kgj >= 0) & (kgj <= self.W - 1)
        return self.mask[None] & inside[:, None, :]


def _windows(x, r0, n, tile, win):
    """(n, win^2, D) halo windows of a padded (rows, cols, D) map for the
    tiles c = 0..n-1 of the tile row whose window starts at row r0."""
    sR, sC, sD = x.stride()
    w = x[r0:].as_strided((n, win, win, x.shape[-1]), (tile * sC, sR, sC, sD))
    return w.reshape(n, win * win, x.shape[-1])


def masked_topk_attention_tiled(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    radius: float,
    temperature: float = 1.0,
    topk: Optional[int] = None,
    normalize: bool = True,
    tile: int = 32,
    mode: str = "softmax",
    mask_shape: str = "circle",
    key_valid: Optional[Sequence[bool]] = None,
    precision: str = "highest",
    topk_impl: str = "exact",
    frame_idx: Optional[Sequence[int]] = None,
    row_offset: Optional[int] = None,
    full_h: Optional[int] = None,
    grid_rows: Optional[int] = None,
) -> torch.Tensor:
    """The 'dense' attention for non_mask_len 0, tile by tile (module
    docstring): (H, W, Cv).  query (H, W, C); key (T, H, W, C), or with
    `frame_idx` (T slots' bank frames) the bank of `pad_key_bank`; value
    (T, H, W, Cv)."""
    if mode not in ("softmax", "cosine"):
        raise ValueError(f"unknown mode {mode}")
    if topk_impl not in TOPK_IMPLS:
        raise ValueError(f"unknown topk_impl {topk_impl}")
    H, W, C = query.shape
    T = value.shape[0] if frame_idx is not None else key.shape[0]
    Cv = value.shape[-1]
    g = TileGeometry(H, W, tile, radius, mask_shape, full_h=full_h, grid_rows=grid_rows,
                     device=query.device)
    win, S, K = g.win, g.S, T * g.win * g.win
    row0 = 0 if row_offset is None else int(row_offset)
    if normalize:
        query = l2_normalize(query)
        if frame_idx is None:
            key = l2_normalize(key)
    qo = operand(g.pad_query(query), precision, "q")
    kpad = g.pad_values(key) if frame_idx is None else key
    frames = list(range(T)) if frame_idx is None else [int(f) for f in frame_idx]
    vpad = g.pad_values(value)
    valid = frame_mask(key_valid, T)
    per_call = max(1, min(g.ntw, TILE_BUDGET // (S * K)))
    out = torch.empty((g.nth, g.ntw, S, Cv), dtype=torch.float32, device=query.device)
    for i in range(g.nth):
        r_loc = i * tile
        r_glob = row0 + r_loc
        for c0 in range(0, g.ntw, per_call):
            n = min(per_call, g.ntw - c0)
            q = qo[r_loc:r_loc + tile, c0 * tile:(c0 + n) * tile]
            q = q.reshape(tile, n, tile, -1).transpose(0, 1).reshape(n, S, -1)
            cols = slice(c0 * tile, None)
            k = torch.cat([_windows(kpad[f][:, cols], r_glob, n, tile, win) for f in frames], 1)
            v = torch.cat([_windows(vpad[t][:, cols], r_glob, n, tile, win) for t in range(T)], 1)
            aff = affinity(q, operand(k, precision, "k")) / temperature     # (n, S, K)
            a4 = aff.view(n, S, T, win * win)
            tc = torch.arange(c0, c0 + n, device=aff.device) * tile
            allowed = g.allowed(torch.full_like(tc, r_glob), tc)
            a4.masked_fill_(~allowed[:, :, None, :], NINF)
            for t in range(T):
                if not valid[t]:
                    a4[:, :, t] = NINF
            out[i, c0:c0 + n] = _mix(aff, v, topk, mode, topk_impl)
    out = out.reshape(g.nth, g.ntw, tile, tile, Cv).permute(0, 2, 1, 3, 4)
    return out.reshape(g.Hp, g.Wp, Cv)[:H, :W]


def _mix(aff, v, topk, mode, topk_impl):
    """(n, S, K) masked affinities, (n, K, Cv) values -> (n, S, Cv) by the
    top-k implementation (module docstring)."""
    if topk is None:
        return mix_all(aff, v, mode)
    if mode != "softmax" or topk_impl == "exact":
        return mix_topk(aff, v, topk, mode)
    if topk_impl == "segmented":
        n, S, K = aff.shape
        w10 = topk_segmented(aff.reshape(n * S, K), topk, seg=512)[0].reshape(n, S, topk)
        return gather_free_value_matmul(aff, w10, v)
    if topk_impl == "certified":
        # the candidates' floor certifies them; exact candidates always pass
        cand = torch.topk(aff, min(max(32, 2 * topk), aff.shape[-1]), dim=-1).values
        return gather_free_value_matmul(aff, cand[..., :topk], v)
    return _approx_value_matmul(aff, torch.topk(aff, topk, dim=-1).values, v)


def masked_topk_attention_tiled_bank_sharded(
    query: torch.Tensor,
    bank_shards: Sequence[torch.Tensor],
    value: torch.Tensor,
    *,
    frame_idx: Sequence[int],
    shard_lo: Sequence[int],
    radius: float,
    temperature: float = 1.0,
    topk: int = 10,
    tile: int = 32,
    mask_shape: str = "circle",
    key_valid: Optional[Sequence[bool]] = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Bank mode of `masked_topk_attention_tiled` over a bank cut into
    contiguous frame shards, each on its own device (fgvc_tpu's
    masked_topk_attention_tiled_bank_sharded, whose three collectives per
    query tile become explicit moves): (H, W, Cv) on the query's device, the
    primary.

    query (H, W, C), pre-normalised, and value (Twin, H, W, Cv) on the
    primary; bank_shards[i] (Tl_i, gridH + 2 * halo, Wp + 2 * halo, C), a
    piece of the pad_key_bank output holding global frames shard_lo[i] ..
    shard_lo[i] + Tl_i - 1, on any device (one may be listed more than once);
    frame_idx the window slots' global frames.  For each piece of query
    tiles:
      1. each shard takes the affinities of the valid slots it owns (a slot
         it does not own is -inf on it in fgvc_tpu, which changes no result)
         and their top-k values on its device, padded with -inf where it
         holds fewer than k live columns;
      2. the lists, copied to the primary, give the global top-k values
         there, and from them the softmax's max and normaliser and the
         threshold (the k-th value);
      3. the count of affinities at the threshold is summed over the shards,
         so the tie split of `gather_free_value_matmul` is global;
      4. each shard mixes its values with those weights on its device, and
         the partial mixes are summed on the primary in shard order, so a
         run repeats itself bit for bit.
    The result equals the unsharded call with topk_impl 'segmented' or
    'certified' up to the partial sums' order (like fgvc_tpu's sharded op,
    which ignores topk_impl); it leaves 'exact' where distinct keys tie at the
    k-th value (the tie split against lax.top_k's lowest index)."""
    if topk is None:
        raise ValueError("bank-sharded attention requires topk")
    if len(bank_shards) != len(shard_lo):
        raise ValueError(f"{len(bank_shards)} bank shards but {len(shard_lo)} shard_lo")
    H, W, _ = query.shape
    Twin, Cv = value.shape[0], value.shape[-1]
    primary = query.device
    frames = [int(f) for f in frame_idx]
    valid = frame_mask(key_valid, Twin)
    # each shard's owned valid slots: (slot, frame within the shard)
    owned = [[(s, f - lo) for s, f in enumerate(frames)
              if valid[s] and lo <= f < lo + bank.shape[0]]
             for bank, lo in zip(bank_shards, shard_lo)]
    devices = list(dict.fromkeys([primary] + [b.device for b in bank_shards]))
    geo = {d: TileGeometry(H, W, tile, radius, mask_shape, device=d) for d in devices}
    g = geo[primary]
    win, S = g.win, g.S
    qo = operand(g.pad_query(query), precision, "q")
    vpad = g.pad_values(value)
    qos = {d: qo.to(d) for d in devices}
    vpads = {d: vpad.to(d) for d in devices}
    per_call = max(1, min(g.ntw, TILE_BUDGET // (S * Twin * win * win)))
    out = torch.zeros((g.nth, g.ntw, S, Cv), dtype=torch.float32, device=primary)
    for i in range(g.nth):
        r = i * tile
        for c0 in range(0, g.ntw, per_call):
            n = min(per_call, g.ntw - c0)
            cols = slice(c0 * tile, None)
            parts, lists = [], []
            for bank, own in zip(bank_shards, owned):
                if not own:  # its list would be all -inf
                    continue
                d = bank.device
                q = qos[d][r:r + tile, c0 * tile:(c0 + n) * tile]
                q = q.reshape(tile, n, tile, -1).transpose(0, 1).reshape(n, S, -1)
                k = torch.cat([_windows(bank[lf][:, cols], r, n, tile, win) for _, lf in own], 1)
                v = torch.cat([_windows(vpads[d][s][:, cols], r, n, tile, win) for s, _ in own], 1)
                aff = affinity(q, operand(k, precision, "k")) / temperature
                tc = torch.arange(c0, c0 + n, device=d) * tile
                allowed = geo[d].allowed(torch.full_like(tc, r), tc)
                aff.view(n, S, len(own), win * win).masked_fill_(~allowed[:, :, None, :], NINF)
                kk = min(topk, aff.shape[-1])
                w_loc = F.pad(torch.topk(aff, kk, dim=-1).values, (0, topk - kk), value=NINF)
                lists.append(w_loc.to(primary))
                parts.append((aff, v))
            if not parts:  # no valid slot: nothing weighs in
                continue
            w10 = torch.topk(torch.cat(lists, -1), topk, dim=-1).values
            m = torch.clamp_min(w10.amax(-1, keepdim=True), -1e30)
            thresh = torch.clamp_min(w10.amin(-1, keepdim=True), -1e30)
            z = torch.exp(w10 - m).sum(-1, keepdim=True) + 1e-30
            n_sel = (w10 == thresh).float().sum(-1, keepdim=True)
            n_at = 0.0
            for aff, _ in parts:
                n_at = n_at + (aff == thresh.to(aff.device)).float().sum(-1, keepdim=True).to(primary)
            tie_frac = torch.where(n_at > 0, n_sel / torch.clamp_min(n_at, 1.0), 0.0)
            mix = 0.0
            for aff, v in parts:
                d = aff.device
                th = thresh.to(d)
                weights = (torch.exp(aff - m.to(d))
                           * ((aff > th).float() + tie_frac.to(d) * (aff == th).float()) / z.to(d))
                mix = mix + (weights @ v).to(primary)
            out[i, c0:c0 + n] = mix
    out = out.reshape(g.nth, g.ntw, tile, tile, Cv).permute(0, 2, 1, 3, 4)
    return out.reshape(g.Hp, g.Wp, Cv)[:H, :W]


def pad_key_bank(bank: torch.Tensor, radius: float, tile: int = 32,
                 grid_rows: Optional[int] = None) -> torch.Tensor:
    """Normalise and halo-pad a (Tb, H, W, C) feature bank once for bank
    mode: (Tb, Hp + 2 * halo, Wp + 2 * halo, C), Hp = `grid_rows` where
    given (spatial-parallel row blocks), else H rounded up to the tile."""
    halo = int(radius)
    H, W = bank.shape[1:3]
    Hp = -(-H // tile) * tile if grid_rows is None else grid_rows
    Wp = -(-W // tile) * tile
    return build_padded_bank(bank, halo=halo, rows_total=Hp + 2 * halo,
                             cols_total=Wp + 2 * halo, normalize=True)
