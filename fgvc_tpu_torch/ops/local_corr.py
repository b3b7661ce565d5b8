"""Local (displacement-window) correlation of the training recipe
(fgvc_tpu/ops/local_corr.py).

    corr[b, i, j, di, dj] = sum_c tar[b, i, j, c] * ref[b, i+di-R, j+dj-R, c]

with zero padding outside the image: raw dot products, which the callers
scale themselves.  As in the JAX package, each vertical displacement di is
one batched (W, C) x (C, W+2R) product per row, and the diagonal band
corr[..., di, :] is read out of it as a strided view.  The rows are laid out
height-first once, so every di's reference rows are a view of one padded
tensor: the backward keeps those two inputs, not a copy per displacement,
and runs the transposed products di by di, with no atomics (deterministic).

`precision` follows the JAX package's matmul precisions, in the products of
the forward and of the backward alike:
  'highest'  float32 (TF32 off: device.set_matmul_precision);
  'high'     bf16x3: a = a_hi + a_lo with a_hi = bf16(a), a_lo = bf16(a -
             a_hi), and a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi;
  'default'  one bf16 product.
Every product accumulates in float32.  In 'high' the three products are one:
the parts concatenated along the contracted axis.  On the card the bf16
parts go to the tensor cores (torch.bmm(..., out_dtype=torch.float32)); on
the CPU, which lacks that product, the bf16-rounded parts are multiplied in
float32, which is exact for them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fgvc_tpu_torch.config import MATMUL_PRECISIONS

__all__ = ["local_correlation", "extract_displacement_windows"]


def _parts(x: torch.Tensor, precision: str, dim: int, order: str) -> torch.Tensor:
    """x as the operand of one product in `precision`: x itself in
    'highest', bf16(x) in 'default', and in 'high' its bf16 parts x_hi =
    bf16(x), x_lo = bf16(x - x_hi) concatenated along the contracted `dim`
    in `order` ('hhl' or 'hlh'), so that one product against the other
    operand's parts in the other order sums hi.hi + hi.lo + lo.hi.  bf16
    tensors on the card; their float32 values on the CPU."""
    if precision == "highest":
        return x
    hi = x.to(torch.bfloat16)
    out = hi
    if precision == "high":
        lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
        out = torch.cat([hi if c == "h" else lo for c in order], dim=dim)
    return out if x.is_cuda else out.to(torch.float32)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in float32 (bf16 operands on the tensor cores)."""
    if a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b)


class _LocalCorrelation(torch.autograd.Function):
    """The correlation over (B, H, W, C) inputs, forward and backward in the
    precision's arithmetic (JAX transposes a dot_general with its
    precision).  Rows are height-first, t (H*B, W, C) and the padded r
    (H+2R, B, W+2R, C), so each di's reference rows are a view of r; the
    operands are split into their bf16 parts once a call, and the
    gradient of r accumulates in place, one di after another."""

    @staticmethod
    def forward(ctx, tar, ref, radius, precision):
        B, H, W, C = tar.shape
        R, win, Wp = radius, 2 * radius + 1, W + 2 * radius
        t = tar.permute(1, 0, 2, 3).reshape(H * B, W, C)
        r = F.pad(ref, (0, 0, R, R, R, R)).permute(1, 0, 2, 3).contiguous()
        tq, rq = _parts(t, precision, 2, "hhl"), _parts(r, precision, 3, "hlh")
        out = tar.new_empty((win, H * B, W, win))
        for di in range(win):
            rows = rq[di:di + H].reshape(H * B, Wp, rq.shape[-1])
            full = _bmm(tq, rows.transpose(1, 2))  # (H*B, W, W+2R)
            # band[n, w, dj] = full[n, w, w + dj]
            out[di] = full.as_strided((H * B, W, win), (W * Wp, Wp + 1, 1))
        ctx.save_for_backward(t, r)
        ctx.geometry = (B, H, W, C, R, precision)
        return out.reshape(win, H, B, W, win).permute(2, 1, 3, 0, 4).contiguous()

    @staticmethod
    def backward(ctx, g_out):
        t, r = ctx.saved_tensors
        B, H, W, C, R, precision = ctx.geometry
        win, Wp, N = 2 * R + 1, W + 2 * R, H * B
        g = g_out.permute(3, 1, 0, 2, 4).reshape(win, N, W, win)
        need_t, need_r = ctx.needs_input_grad[:2]
        gt = torch.zeros_like(t) if need_t else None
        gr = torch.zeros_like(r) if need_r else None
        rq = _parts(r, precision, 2, "hlh") if need_t else None  # contracted: W+2R
        tq = _parts(t, precision, 1, "hlh") if need_r else None  # contracted: W
        gfull = t.new_zeros((N, W, Wp))
        band = gfull.as_strided((N, W, win), (W * Wp, Wp + 1, 1))
        for di in range(win):
            band.copy_(g[di])
            if need_t:
                rows = rq[di:di + H].reshape(N, rq.shape[2], C)
                gt += _bmm(_parts(gfull, precision, 2, "hhl"), rows)
            if need_r:
                gq = _parts(gfull, precision, 1, "hhl").transpose(1, 2)
                gr[di:di + H] += _bmm(gq, tq).reshape(H, B, Wp, C)
        grad_tar = gt.reshape(H, B, W, C).permute(1, 0, 2, 3) if need_t else None
        grad_ref = gr.permute(1, 0, 2, 3)[:, R:R + H, R:R + W] if need_r else None
        return grad_tar, grad_ref, None, None


def _batched(x: torch.Tensor):
    return (x, False) if x.dim() == 4 else (x[None], True)


def local_correlation(
    tar: torch.Tensor, ref: torch.Tensor, radius: int, precision: str = "highest"
) -> torch.Tensor:
    """(B, H, W, C) target and reference features (or (H, W, C)) ->
    (B, H, W, 2R+1, 2R+1) raw dot products; [.., i, j, di, dj] pairs tar[i, j]
    with ref[i + di - R, j + dj - R] (0 outside the image)."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(
            f"precision must be one of {MATMUL_PRECISIONS}, got {precision!r}"
        )
    tar, squeeze = _batched(tar)
    ref, _ = _batched(ref)
    out = _LocalCorrelation.apply(tar, ref, radius, precision)
    return out[0] if squeeze else out


def extract_displacement_windows(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, H, W, C) (or (H, W, C)) -> (B, H, W, 2R+1, 2R+1, C);
    [.., i, j, di, dj, :] = x[i + di - R, j + dj - R] (0 outside)."""
    x, squeeze = _batched(x)
    B, H, W, C = x.shape
    win = 2 * radius + 1
    cols = F.unfold(x.permute(0, 3, 1, 2), win, padding=radius)  # (B, C*win*win, H*W)
    out = cols.reshape(B, C, win, win, H, W).permute(0, 4, 5, 2, 3, 1)
    return out[0] if squeeze else out
