"""Exact top-k with jax.lax.top_k's order, and the segment-max prefiltered
top-k (fgvc_tpu/ops/topk.py).

``top_k`` returns the k largest along the last axis in descending order,
equal values in index order, as lax.top_k does.  ``torch.topk`` gives the
same values but may order ties otherwise and so pick other positions at the
k-th value; a stable sort of the whole row gives lax.top_k's positions but
sorts 23,064 affinities a query pixel in attention_impl 'tiled' and 98,304 in
'dense'.  So ``top_k`` takes the k-th value from ``torch.topk`` and then
selects, in index order, the members above it and the first members equal to
it: a few passes over the row instead of a sort.  Rows must hold no NaN.

``topk_segmented`` ranks segments of `seg` columns by their maxima, keeps
the k best segments (a row's top k lie in them: fewer than k other segments
can hold a larger maximum), and takes the top k of their columns.  Its
values equal top_k's; ties break by segment order, then position, as
fgvc_tpu's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, as
    jax.lax.top_k: descending, equal values in index order."""
    K = x.shape[-1]
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > kth
    at = x == kth
    # the first (k - members above) members at the k-th value, by index
    room = k - above.sum(-1, keepdim=True, dtype=torch.int32)
    sel = above | (at & (torch.cumsum(at, -1, dtype=torch.int32) <= room))
    pos = torch.arange(K, device=x.device, dtype=torch.int32)
    idx = torch.topk(torch.where(sel, pos, K), k, dim=-1, largest=False).indices
    vals = torch.gather(x, -1, idx)  # the k selected, in index order
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return torch.gather(vals, -1, order), torch.gather(idx, -1, order)


def topk_segmented(aff: torch.Tensor, k: int, seg: int = 128):
    """Exact (values, indices) top-k along the last axis of a 2-D array by
    segment-max prefiltering: the k segments of `seg` columns with the
    largest maxima (top_k's order), then top_k over those segments' columns
    in that order."""
    S, K = aff.shape
    n_seg = -(-K // seg)
    a = F.pad(aff, (0, n_seg * seg - K), value=float("-inf")).reshape(S, n_seg, seg)
    _, seg_idx = top_k(a.amax(-1), min(k, n_seg))
    cand = torch.gather(a, 1, seg_idx[:, :, None].expand(-1, -1, seg)).reshape(S, -1)
    vals, ci = top_k(cand, k)
    seg_of = torch.gather(seg_idx, 1, torch.div(ci, seg, rounding_mode="floor"))
    return vals, seg_of * seg + ci % seg
