"""L2 normalisation and the halo-padded key bank (fgvc_tpu/ops/attention.py)."""

from __future__ import annotations

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
