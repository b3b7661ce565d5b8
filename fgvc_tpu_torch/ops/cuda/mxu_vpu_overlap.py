"""Tensor-core / SIMT overlap microbenchmark (kernel K6).

Counterpart of tools/bench/mxu_vpu_overlap.py (``make(kind)``): three kernels
at the shapes of the top-k attention's passes A and B (S = 256 rows, FK = 2304
columns, C = 256 channels, T = 6 frames, R = 11 rounds):

* 'mxu'   ``out = sum_t (q . k_t^T)[:, :128]``, each (S, FK) product also
  stored into an (S, T * FK) scratch;
* 'vpu'   R rounds of ``count(a >= prev)`` and ``max(a < prev)`` over the
  whole scratch, after its first FK columns are filled with ``q[:, 0]``; the
  other columns are never written and hold NaN, as in Pallas interpret mode,
  so every row of the result is 10 * FK;
* 'mixed' per frame the product and 2 rounds over frame 0's block;
  ``out = acc + tot``.

``overlap`` launches the hand-written CUDA kernel of csrc/mxu_vpu_overlap.cu
(products on the tensor cores in 3xTF32, rounds on SIMT warps of the same
block) for CUDA tensors and runs ``overlap_plain`` for CPU tensors.  The
source says what it measures on an H100 and what bounds it.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional

import torch

S, FK, C, T, R = 256, 2304, 256, 6, 11
OUTW = 128
NEG = -1e30
KINDS = ("mxu", "vpu", "mixed")

# kernel launches per kind since the last reset
launches: Dict[str, int] = dict.fromkeys(KINDS, 0)


def reset_launches() -> None:
    for kind in launches:
        launches[kind] = 0


def new_scratch(device) -> torch.Tensor:
    """An (S, T * FK) float32 scratch filled with NaN, the value Pallas
    interpret mode gives the columns the 'vpu' kind never writes.  A
    scratch may be reused across calls of one kind: 'mxu' and 'mixed'
    rewrite every column they read, 'vpu' the same first FK columns."""
    return torch.full((S, T * FK), float("nan"), dtype=torch.float32, device=device)


def overlap_quality(times: Dict[str, float]) -> Dict[str, float]:
    """The original's normalisation (mxu_vpu_overlap.py:125-131): 'mixed'
    runs 2T rounds over a T times smaller block than 'vpu''s R rounds, so
    its rounds are worth vpu * 2T / (R * T); quality 1.0 means they hide
    fully behind the products."""
    vpu_frac = (T * 2) / (R * T)
    serial = times["mxu"] + times["vpu"] * vpu_frac
    return {"vpu_frac": vpu_frac, "expected_serial": serial,
            "overlap": (serial - times["mixed"]) / (times["vpu"] * vpu_frac)}


def _check(kind, q, k):
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if q.shape != (S, C) or k.shape != (T, FK, C):
        raise ValueError(
            f"q must be ({S}, {C}) and k ({T}, {FK}, {C}), got {tuple(q.shape)} "
            f"and {tuple(k.shape)}"
        )
    for name, x in (("q", q), ("k", k)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")


def overlap(kind: str, q: torch.Tensor, k: torch.Tensor,
            scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, 128) float32 result of `kind` on q (S, C) and k (T, FK, C).  CPU
    tensors take the plain version; CUDA tensors take the kernel, or raise.
    `scratch` (from new_scratch, on the kernel's device) keeps its NaN fill
    out of a timed loop; without it each call allocates one."""
    _check(kind, q, k)
    if q.device.type == "cpu" and k.device.type == "cpu":
        return overlap_plain(kind, q, k)
    if scratch is None:
        scratch = new_scratch(q.device)
    tensors = {"q": q, "k": k, "scratch": scratch}
    for name, x in tensors.items():
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must lie on the CUDA device of q ({q.device}), got {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if scratch.shape != (S, T * FK) or scratch.dtype != torch.float32:
        raise ValueError(f"scratch must be ({S}, {T * FK}) float32, got {tuple(scratch.shape)}")
    out = torch.empty((S, OUTW), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()(KINDS.index(kind), q.data_ptr(), k.data_ptr(), out.data_ptr(),
                         scratch.data_ptr(), stream)
    if err:
        raise RuntimeError(f"mxu_vpu_overlap kernel launch failed: CUDA error {err}")
    launches[kind] += 1
    return out


def _library():
    from fgvc_tpu_torch.ops.cuda.build import load

    fn = load("mxu_vpu_overlap").fgvc_mxu_vpu_overlap
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def tf32_off():
    """float32 matrix products without TF32 inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _rounds(a, prev, tot, n):
    """n rounds of count(a >= prev) and max(a < prev) over the rows of a."""
    for _ in range(n):
        tot = tot + (a >= prev).float().sum(-1, keepdim=True)
        prev = torch.where(a < prev, a, NEG).amax(-1, keepdim=True)
    return prev, tot


def overlap_plain(kind: str, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """`kind` in plain PyTorch on the device of q: float32 products
    (torch.matmul, TF32 off) and the same rounds over a NaN-filled scratch."""
    _check(kind, q, k)
    dev = q.device
    scratch = new_scratch(dev)
    acc = torch.zeros((S, OUTW), device=dev)
    prev = torch.full((S, 1), 1e30, device=dev)
    tot = torch.zeros((S, 1), device=dev)
    if kind == "vpu":
        scratch[:, :FK] = q[:, :1]
        _, tot = _rounds(scratch, prev, tot, R)
        return tot + acc
    with tf32_off():
        for t in range(T):
            a = torch.matmul(q, k[t].T)
            scratch[:, t * FK:(t + 1) * FK] = a
            if kind == "mixed":
                prev, tot = _rounds(scratch[:, :FK], prev, tot, 2)
            acc = acc + a[:, :OUTW]
    return acc if kind == "mxu" else acc + tot
