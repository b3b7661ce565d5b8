"""Coarse-to-fine and flow-guided attention, attention_impl 'c2f' and
'flow_guided' (fgvc_tpu/ops/c2f.py).  Plain PyTorch, float32 products (JAX
runs them at Precision.HIGHEST), query pixels in chunks so the window
gathers stay bounded.

* ``masked_attention_c2f``: a coarse stage picks, per key frame, the
  radius-masked argmax of each coarse query's affinities; a fine stage
  gathers the (2 * radius_fine + 1)^2 fine keys and values around each
  coarse match (times the scale) and mixes the top-k over all frames'
  patches.  Output on the coarse grid.
* ``flow_guided_attention`` (the dense form, an oracle for the tests):
  bilinear samples of a precomputed (T, Hq, Wq, H, W) correlation volume
  over a (2r+1)^2 window around pixel + flow; values sampled nearest;
  temperature unused, as in the reference.
* ``flow_guided_topk_attention``: the same affinities formed directly
  against the key features (correlation is linear in the keys), divided by
  the temperature, without the volume: fgvc_tpu dots each query with its
  part_unfold window of bilinearly sampled keys; here the correlation is
  taken on the window's integer points and blended bilinearly
  (`_window_correlation`), the same function to float rounding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from fgvc_tpu_torch.ops.attention import NINF, frame_mask, l2_normalize
from fgvc_tpu_torch.ops.topk import top_k
from fgvc_tpu_torch.ops.warp import bilinear_sample


def _window_offsets(r: int, device) -> torch.Tensor:
    """(P2, 2) (x, y) offsets of a (2r+1)^2 window, rows of y."""
    offs = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    return torch.stack([offs.repeat(2 * r + 1), offs.repeat_interleave(2 * r + 1)], dim=-1)


def _mix(aff: torch.Tensor, vals: torch.Tensor, topk: int) -> torch.Tensor:
    """(s, K) affinities, (s, K, Cv) candidate values -> (s, Cv): the
    top-k softmaxed over their values."""
    w, idx = top_k(aff, topk)
    w = torch.softmax(w, dim=-1)
    picked = torch.gather(vals, 1, idx[..., None].expand(-1, -1, vals.shape[-1]))
    return (w[:, None, :] @ picked)[:, 0]


def masked_attention_c2f(
    query: torch.Tensor,       # (hc, wc, C) coarse query features
    key: torch.Tensor,         # (T, hc, wc, C) coarse key features
    query_fine: torch.Tensor,  # (hf, wf, Cf) fine query features
    key_fine: torch.Tensor,    # (T, hf, wf, Cf) fine key features
    value: torch.Tensor,       # (T, hf, wf, Cv) fine value maps
    *,
    radius: Optional[float],
    radius_fine: int = 12,
    temperature: float = 1.0,
    topk: int = 10,
    normalize: bool = True,
    key_valid: Optional[Sequence[bool]] = None,
    step: Optional[int] = None,
) -> torch.Tensor:
    """(hc, wc, Cv) values on the coarse grid.  `key_valid` drops whole key
    frames from the fine stage's top-k (the coarse argmax ignores it, as in
    fgvc_tpu); `step` query pixels a chunk (all at once where None)."""
    hc, wc, C = query.shape
    T = key.shape[0]
    hf, wf, Cf = query_fine.shape
    Cv = value.shape[-1]
    scale = hf // hc
    Q = hc * wc
    rf = radius_fine
    P2 = (2 * rf + 1) ** 2
    if normalize:
        query, key = l2_normalize(query), l2_normalize(key)
        query_fine, key_fine = l2_normalize(query_fine), l2_normalize(key_fine)
    dev = query.device

    # coarse stage: (T, K, Q) affinities, argmax over the keys per frame
    aff = (key.reshape(T, Q, C) @ query.reshape(Q, C).T) / temperature
    if radius is not None:
        gy = torch.arange(hc, device=dev, dtype=torch.float32).repeat_interleave(wc)
        gx = torch.arange(wc, device=dev, dtype=torch.float32).repeat(hc)
        d2 = (gy[:, None] - gy[None, :]) ** 2 + (gx[:, None] - gx[None, :]) ** 2
        aff = aff.masked_fill(~(d2 < radius * radius)[None], NINF)
    best = torch.argmax(aff, dim=1)                              # (T, Q), first maximum
    del aff

    # fine stage: patches around the coarse matches, as flat indices into
    # the rf-padded fine maps
    wpad = wf + 2 * rf
    off = _window_offsets(rf, dev).long()                        # (P2, 2)
    by = torch.div(best, wc, rounding_mode="floor") * scale      # (T, Q)
    bx = (best % wc) * scale
    lin = ((by[..., None] + off[:, 1] + rf) * wpad + bx[..., None] + off[:, 0] + rf)  # (T, Q, P2)
    kf = F.pad(key_fine, (0, 0, rf, rf, rf, rf)).reshape(T, -1, Cf)
    vf = F.pad(value, (0, 0, rf, rf, rf, rf)).reshape(T, -1, Cv)
    qf = query_fine[::scale, ::scale].reshape(Q, Cf)
    valid = frame_mask(key_valid, T)
    s = Q if step is None or step >= Q else step
    out = value.new_empty((Q, Cv), dtype=torch.float32)
    for q0 in range(0, Q, s):
        q1 = min(Q, q0 + s)
        n = q1 - q0
        idx = lin[:, q0:q1].reshape(T, n * P2)
        kp = torch.gather(kf, 1, idx[..., None].expand(-1, -1, Cf)).reshape(T * n, P2, Cf)
        qc = qf[q0:q1].expand(T, n, Cf).reshape(T * n, Cf, 1)
        fa = (kp @ qc).reshape(T, n, P2) / temperature           # (T, n, P2)
        for t in range(T):
            if not valid[t]:
                fa[t] = NINF
        fa = fa.permute(1, 0, 2).reshape(n, T * P2)
        vp = torch.gather(vf, 1, idx[..., None].expand(-1, -1, Cv)).reshape(T, n, P2, Cv)
        out[q0:q1] = _mix(fa, vp.permute(1, 0, 2, 3).reshape(n, T * P2, Cv), topk)
    return out.reshape(hc, wc, Cv)


def _nearest_values(vf: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(h, w, Cv) map sampled nearest at (..., 2) float (x, y) points (round
    half to even), 0 outside [0, w-1] x [0, h-1]."""
    h, w = vf.shape[:2]
    x = torch.clamp(torch.round(pts[..., 0]), 0, w - 1).long()
    y = torch.clamp(torch.round(pts[..., 1]), 0, h - 1).long()
    inside = (pts[..., 0] >= 0) & (pts[..., 0] <= w - 1) & (pts[..., 1] >= 0) & (pts[..., 1] <= h - 1)
    return vf[y, x] * inside[..., None]


def flow_guided_attention(
    corr: torch.Tensor,    # (T, Hq, Wq, H, W) correlation volumes per key frame
    flow: torch.Tensor,    # (T, Hq, Wq, 2) query -> key flow predictions
    value: torch.Tensor,   # (T, H, W, Cv)
    *,
    radius: int = 6,
    temperature: float = 0.07,
    topk: int = 10,
) -> torch.Tensor:
    """(Hq, Wq, Cv): the dense form (module docstring); `temperature` is
    unused, as in the reference (its caller divides the volume)."""
    del temperature
    T, Hq, Wq, H, W = corr.shape
    Cv = value.shape[-1]
    Q = Hq * Wq
    P2 = (2 * radius + 1) ** 2
    gy, gx = torch.meshgrid(torch.arange(Hq, device=corr.device, dtype=torch.float32),
                            torch.arange(Wq, device=corr.device, dtype=torch.float32),
                            indexing="ij")
    centers = torch.stack([gx[None] + flow[..., 0], gy[None] + flow[..., 1]], -1)
    pts = centers.reshape(T, Q, 1, 2) + _window_offsets(radius, corr.device)[None, None]
    aff = bilinear_sample(corr.reshape(T * Q, H, W, 1), pts.reshape(T * Q, P2, 2))
    aff = aff.reshape(T, Q, P2)
    vals = torch.stack([_nearest_values(value[t], pts[t]) for t in range(T)])  # (T, Q, P2, Cv)
    out = _mix(aff.permute(1, 0, 2).reshape(Q, T * P2),
               vals.permute(1, 0, 2, 3).reshape(Q, T * P2, Cv), topk)
    return out.reshape(Hq, Wq, Cv)


def _window_correlation(kf: torch.Tensor, q: torch.Tensor, ctr: torch.Tensor,
                        r: int) -> torch.Tensor:
    """(n, (2r+1)^2) dot products of each query q (n, C) with the key map kf
    (h, w, C) bilinearly sampled (0 outside) on the window of offsets -r..r
    around its centre ctr (n, 2) (x, y): what part_unfold's window dotted
    with q gives.  The window's points share the centre's fraction, so the
    correlation is taken once on the (2r+2)^2 integer points from floor(ctr)
    - r and blended at the four corners of each point, in bilinear_sample's
    order: one gather of key vectors instead of four, and no sampled feature
    window."""
    h, w, C = kf.shape
    n = ctr.shape[0]
    m = 2 * r + 2
    fl = torch.floor(ctr)
    fx, fy = (ctr - fl).unbind(-1)
    offs = torch.arange(m, device=kf.device, dtype=torch.float32)
    ix = fl[:, None, 0] - r + offs                                    # (n, m)
    iy = fl[:, None, 1] - r + offs
    inside = (((iy >= 0) & (iy <= h - 1))[:, :, None] & ((ix >= 0) & (ix <= w - 1))[:, None, :])
    idx = (iy.clamp(0, h - 1).long() * w)[:, :, None] + ix.clamp(0, w - 1).long()[:, None, :]
    kw = kf.reshape(h * w, C)[idx.reshape(n, m * m)]                  # (n, m^2, C)
    corr = (kw @ q[:, :, None]).reshape(n, m, m) * inside
    wx0, wy0 = (1.0 - fx)[:, None, None], (1.0 - fy)[:, None, None]
    wx1, wy1 = fx[:, None, None], fy[:, None, None]
    out = (corr[:, :-1, :-1] * (wx0 * wy0) + corr[:, :-1, 1:] * (wx1 * wy0)
           + corr[:, 1:, :-1] * (wx0 * wy1) + corr[:, 1:, 1:] * (wx1 * wy1))
    return out.reshape(n, (m - 1) ** 2)


def flow_guided_topk_attention(
    query: torch.Tensor,   # (h, w, C)
    keys: torch.Tensor,    # (T, h, w, C)
    values: torch.Tensor,  # (T, h, w, Cv)
    flows: torch.Tensor,   # (T, h, w, 2) query -> key flow (x, y), feature pixels
    *,
    radius: int = 6,
    temperature: float = 0.07,
    topk: int = 10,
    normalize: bool = True,
    key_valid: Optional[Sequence[bool]] = None,
    step: int = 1024,
) -> torch.Tensor:
    """(h, w, Cv): the efficient form (module docstring).  Values are
    sampled nearest and zeroed outside the image; candidates outside enter
    the top-k at affinity 0 (the zero padding), invalid frames at -inf."""
    T, h, w, C = keys.shape
    Cv = values.shape[-1]
    Q = h * w
    P2 = (2 * radius + 1) ** 2
    if normalize:
        query, keys = l2_normalize(query), l2_normalize(keys)
    gy, gx = torch.meshgrid(torch.arange(h, device=query.device, dtype=torch.float32),
                            torch.arange(w, device=query.device, dtype=torch.float32),
                            indexing="ij")
    base = torch.stack([gx, gy], dim=-1).reshape(Q, 2)
    centers = base[None] + flows.reshape(T, Q, 2)                 # (T, Q, 2)
    owin = _window_offsets(radius, query.device)
    valid = frame_mask(key_valid, T)
    qf = query.reshape(Q, C)
    out = values.new_empty((Q, Cv), dtype=torch.float32)
    s = min(step, Q)
    for q0 in range(0, Q, s):
        q1 = min(Q, q0 + s)
        n = q1 - q0
        affs, vals = [], []
        for t in range(T):
            ctr = centers[t, q0:q1]
            aff = _window_correlation(keys[t], qf[q0:q1], ctr, radius) / temperature
            affs.append(aff if valid[t] else torch.full_like(aff, NINF))
            vals.append(_nearest_values(values[t], ctr[:, None, :] + owin[None]))
        aff = torch.stack(affs, 1).reshape(n, T * P2)
        out[q0:q1] = _mix(aff, torch.stack(vals, 1).reshape(n, T * P2, Cv), topk)
    return out.reshape(h, w, Cv)
