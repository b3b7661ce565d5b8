"""Windowed top-k attention over a halo-padded key bank (kernels K1-K4).

Counterpart of fgvc_tpu/ops/pallas/topk_attention.py, with its two entries
over one kernel body:

* ``topk_attention_banked`` (K1, ``fused_topk_attention_banked``): keys come
  from a bank that ``pad_key_bank`` normalised and halo-padded once;
* ``topk_attention`` (K2, ``fused_topk_attention``): raw (Tb, H, W, C) keys,
  normalised and halo-padded into the same geometry on every call.

``topk_attention_banked`` with ``row0`` and ``grid_rows`` is K4, the row-block
mode of spatial-parallel propagation: the query is the block of hb rows of a
grid over-padded to ``grid_rows`` rows that starts at global row ``row0``, the
bank comes from ``pad_key_bank(..., grid_rows=)``, and the result is the
block's (hb, W, Cv) rows, zero at and past H.  Blocks assemble to the
unsharded result bit for bit.

``topk_attention_op`` registers K2 as the operator
``fgvc_tpu_torch::topk_attention``, the one node of the exported serving step
that holds the kernel (core/export.py).

``topk_attention(..., debug_passes='a'|'ab')`` is K5, the Pallas kernel's
profiling cut-downs (``fused_topk_attention(debug_passes=)``, which
tools/bench/pass_breakdown.py times): 'a' runs pass A alone and returns slot
0's masked affinities at the Pallas window columns 0..Cv-1; 'ab' runs passes A
and B and returns [thresh, mmax, z, frac, n_above, cnt_at], zero-padded (or
cut) to Cv.  JAX has them on the unbanked entry only, and so has the port.

Both take the Pallas kernel's ``compute_dtype`` (K3): 'float32' (f32
operands; the kernel's affinities as 3xTF32 products, the plain version's in
f32), 'high' (f32 operands, each product as the three bf16 products hi.hi +
hi.lo + lo.hi of its bf16 halves, f32 sums) or 'bfloat16' (a bf16 query and
bank, bf16 products and values, f32 sums); ``pallas_compute_dtype`` maps
TestConfig.matmul_precision onto it.  The kernel sums on the tensor cores in
an order PyTorch cannot repeat, so it agrees with the plain version to
rounding, and where a row's k-th and (k+1)-th largest affinities lie within
rounding of each other (``near_tie_rows``) it may select another member.

Both launch the hand-written CUDA kernel of csrc/topk_attention.cu for CUDA
tensors, and run a straightforward PyTorch version of the same function
(``topk_attention_banked_plain``, ``topk_attention_plain``) for CPU tensors.
See the kernel source for what bounds it on an H100 and how its design
handles the Pallas kernel's VMEM-resident affinity.

Semantics (the Pallas kernel's, tie rule included): every query pixel attends
over the win x win halo window (win = tile + 2 * halo) of T key slots, masked
to the radius window (mask_shape 'circle': the strict dy^2 + dx^2 < radius^2;
'square': the inclusive |dy| <= radius and |dx| <= radius), to keys inside
the image and to valid slots; the k largest affinities are softmaxed and mix
the slot values.  Candidates tied at the k-th value share the remaining
(k - n_above) slots equally; rows with fewer than k live keys take every live
key once.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from fgvc_tpu_torch.ops.attention import build_padded_bank, l2_normalize

NEG = -1e30
MAX_T = 16      # key slots the kernel's parameter block holds
MAX_TOPK = 31   # largest k: the kernel's bound takes the k-th of a warp's 32 maxima
MASK_SHAPES = ("circle", "square")
PLAIN_CHUNK_TILES = 64  # query tiles per step of the plain version

# compute_dtype -> query and bank dtype (the Pallas _PALLAS_PRECISIONS); the
# values are float32 at the interface in every mode
COMPUTE_DTYPES = {
    "float32": torch.float32,
    "high": torch.float32,
    "bfloat16": torch.bfloat16,
}
_ENTRY_SUFFIX = {"float32": "f32", "high": "high", "bfloat16": "bf16"}
# debug_passes of the unbanked entry: the whole kernel, or a K5 cut-down
# (the number is the kernel's PASSES)
DEBUG_PASSES = {"a": 1, "ab": 2, "abc": 3}
N_STATS = 6  # thresh, mmax, z, frac, n_above, cnt_at
# near_tie_rows: affinities this close to the k-th largest make a near tie
NEAR_TIE_TOL = 1e-4

# Kernel launches since the last reset: one count per entry, K1 (banked),
# K2 (unbanked) and K4 (banked, one row block), and one per compute mode over
# all three; K5's cut launches apart, per cut, in none of the others.
launches = 0
unbanked_launches = 0
row_block_launches = 0
mode_launches = dict.fromkeys(COMPUTE_DTYPES, 0)
cut_launches = {"a": 0, "ab": 0}


def reset_launches() -> None:
    global launches, unbanked_launches, row_block_launches
    launches = unbanked_launches = row_block_launches = 0
    for counts in (mode_launches, cut_launches):
        for key in counts:
            counts[key] = 0


def pallas_compute_dtype(matmul_precision: str) -> str:
    """TestConfig.matmul_precision -> compute_dtype: 'default' runs
    'bfloat16', 'high' runs 'high', anything else 'float32'."""
    return {"default": "bfloat16", "high": "high"}.get(matmul_precision, "float32")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bank_geometry(H: int, W: int, radius: float, tile: int,
                  grid_rows: Optional[int] = None):
    """(halo, Hp, Wp, rows_total, cols_total) of pad_key_bank_pallas; Hp is
    `grid_rows` where given (the row blocks' over-padded grid)."""
    halo = int(radius)
    win = tile + 2 * halo
    Hp = _round_up(H, tile) if grid_rows is None else grid_rows
    Wp = _round_up(W, tile)
    pad8 = _round_up(win, 8) - win
    return halo, Hp, Wp, H + 2 * halo + (Hp - H) + pad8, W + 2 * halo + (Wp - W) + pad8


def pad_key_bank(
    bank: torch.Tensor, radius: float, tile: int = 16, normalize: bool = True,
    compute_dtype: str = "float32", grid_rows: Optional[int] = None,
) -> torch.Tensor:
    """Normalise (in float32) and halo-pad a (Tb, H, W, C) feature bank once,
    in the geometry and the dtype of pad_key_bank_pallas: bfloat16 for
    compute_dtype 'bfloat16', float32 otherwise.  `grid_rows` over-pads the
    rows for row blocks (K4)."""
    H, W = bank.shape[1:3]
    halo, _, _, rows_total, cols_total = bank_geometry(H, W, radius, tile, grid_rows)
    return build_padded_bank(
        bank, halo=halo, rows_total=rows_total, cols_total=cols_total,
        normalize=normalize, dtype=_operand_dtype(compute_dtype),
    )


def _operand_dtype(compute_dtype: str) -> torch.dtype:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, got {compute_dtype!r}"
        )
    return COMPUTE_DTYPES[compute_dtype]


def _check(qpad, kpad, value, frame_idx, key_valid, H, W, radius, topk, tile,
           mask_shape, compute_dtype, *, row0=None, grid_rows=None):
    want = _operand_dtype(compute_dtype)
    if compute_dtype == "high" and qpad.dtype != torch.float32:
        # bf16 operands would make the lo halves zero: plain bf16 accuracy
        # under the name of bf16x3 (the Pallas kernel's rule)
        raise ValueError(
            "compute_dtype='high' needs float32 query/key operands; the "
            f"given bank is {qpad.dtype}"
        )
    for name, x, dt in (("qpad", qpad, want), ("kpad", kpad, want),
                        ("value", value, torch.float32)):
        if x.dtype != dt:
            raise TypeError(
                f"{name} must be {dt} for compute_dtype {compute_dtype!r}, got {x.dtype}"
            )
    if (row0 is None) != (grid_rows is None):
        raise ValueError("a row block needs both row0 and grid_rows")
    halo, Hp, Wp, rows_total, cols_total = bank_geometry(H, W, radius, tile, grid_rows)
    T = value.shape[0]
    if row0 is not None:
        hb = qpad.shape[0]
        if grid_rows % tile or grid_rows < _round_up(H, tile):
            raise ValueError(
                f"grid_rows must be a multiple of {tile} covering {H} rows, got {grid_rows}"
            )
        if hb < tile or hb % tile or row0 < 0 or row0 % tile or row0 + hb > grid_rows:
            raise ValueError(
                f"a row block needs hb % {tile} == 0 and row0 % {tile} == 0 with "
                f"row0 + hb <= {grid_rows}, got hb {hb}, row0 {row0}"
            )
        Hp = hb
    if qpad.shape[:2] != (Hp, Wp) or qpad.dim() != 3:
        raise ValueError(f"qpad must be ({Hp}, {Wp}, C), got {tuple(qpad.shape)}")
    C = qpad.shape[2]
    if kpad.dim() != 4 or kpad.shape[1:] != (rows_total, cols_total, C):
        raise ValueError(
            f"kpad must be (Tb, {rows_total}, {cols_total}, {C}) from "
            f"pad_key_bank, got {tuple(kpad.shape)}"
        )
    if value.dim() != 4 or value.shape[1:3] != (H, W):
        raise ValueError(f"value must be (T, {H}, {W}, Cv), got {tuple(value.shape)}")
    if len(frame_idx) != T or len(key_valid) != T:
        raise ValueError(f"frame_idx and key_valid need {T} entries")
    if not all(0 <= int(i) < kpad.shape[0] for i in frame_idx):
        raise ValueError(f"frame_idx {list(frame_idx)} outside the bank")
    if not 1 <= topk:
        raise ValueError(f"topk must be positive, got {topk}")
    if mask_shape not in MASK_SHAPES:
        raise ValueError(f"mask_shape must be one of {MASK_SHAPES}, got {mask_shape!r}")


def _check_cut(debug_passes, Cv, radius, tile, row0):
    """A K5 cut runs on the unbanked entry only, and cut 'a' emits at most
    slot 0's wpad^2 columns of the Pallas affinity row."""
    if debug_passes not in DEBUG_PASSES:
        raise ValueError(
            f"debug_passes must be one of {tuple(DEBUG_PASSES)}, got {debug_passes!r}"
        )
    if debug_passes == "abc":
        return
    if row0 is not None:
        raise ValueError("the K5 cut-downs have no row-block mode")
    wpad = _round_up(tile + 2 * int(radius), 8)
    if debug_passes == "a" and Cv > wpad * wpad:
        raise ValueError(f"cut 'a' emits slot 0's {wpad * wpad} columns; Cv is {Cv}")


def _on_cpu(*tensors) -> bool:
    return all(x.device.type == "cpu" for x in tensors)


def topk_attention_banked(
    qpad: torch.Tensor,    # (Hp, Wp, C) normalised padded query
    kpad: torch.Tensor,    # (Tb, rows_total, cols_total, C) from pad_key_bank
    value: torch.Tensor,   # (T, H, W, Cv) value maps of the T key slots
    *,
    frame_idx: Sequence[int],   # (T,) bank frame of each key slot
    key_valid: Sequence[bool],  # (T,) slot validity
    H: int,
    W: int,
    radius: float,
    temperature: float = 1.0,
    topk: int = 10,
    tile: int = 16,
    mask_shape: str = "circle",
    compute_dtype: str = "float32",
    row0: Optional[int] = None,        # K4: global row of qpad's first row
    grid_rows: Optional[int] = None,   # K4: rows of the over-padded grid
) -> torch.Tensor:
    """K1 (K3 in 'high' and 'bfloat16'): (H, W, Cv) float32 propagated
    values; qpad and kpad in the mode's dtype (pad_key_bank), value float32.
    With row0 and grid_rows, K4: qpad is an (hb, Wp, C) row block, kpad
    comes from pad_key_bank(..., grid_rows=grid_rows), and the result is
    (hb, W, Cv), zero at global rows >= H.  CPU tensors take the plain
    version; CUDA tensors take the kernel, or raise."""
    global launches, row_block_launches
    kw = dict(frame_idx=frame_idx, key_valid=key_valid, H=H, W=W, radius=radius,
              temperature=temperature, topk=topk, tile=tile, mask_shape=mask_shape,
              compute_dtype=compute_dtype, row0=row0, grid_rows=grid_rows)
    if _on_cpu(qpad, kpad, value):
        return topk_attention_banked_plain(qpad, kpad, value, **kw)
    out = _launch(qpad, kpad, value, **kw)
    if row0 is None:
        launches += 1
    else:
        row_block_launches += 1
    mode_launches[compute_dtype] += 1
    return out


def _prepare_unbanked(query, key, value, key_valid, radius, temperature, topk,
                      tile, normalize, mask_shape, compute_dtype):
    """fused_topk_attention's per-call preparation: optional l2 norm (in
    float32), the query zero-padded to (Hp, Wp), the keys halo-padded into the
    bank geometry, both cast to the mode's dtype; returns (qpad, kpad, the
    banked entry's keyword arguments)."""
    H, W, C = query.shape
    if key.dim() != 4 or key.shape[1:] != query.shape:
        raise ValueError(f"key must be (Tb, {H}, {W}, {C}), got {tuple(key.shape)}")
    dtype = _operand_dtype(compute_dtype)
    halo, Hp, Wp, rows_total, cols_total = bank_geometry(H, W, radius, tile)
    qpad = torch.zeros((Hp, Wp, C), dtype=dtype, device=query.device)
    qpad[:H, :W] = (l2_normalize(query) if normalize else query).to(dtype)
    kpad = build_padded_bank(
        key, halo=halo, rows_total=rows_total, cols_total=cols_total,
        normalize=normalize, dtype=dtype,
    )
    T = value.shape[0]
    valid = [True] * T if key_valid is None else [bool(v) for v in key_valid]
    kw = dict(frame_idx=list(range(T)), key_valid=valid, H=H, W=W, radius=radius,
              temperature=temperature, topk=topk, tile=tile, mask_shape=mask_shape,
              compute_dtype=compute_dtype)
    return qpad, kpad, kw


def topk_attention(
    query: torch.Tensor,   # (H, W, C)
    key: torch.Tensor,     # (Tb, H, W, C), Tb >= T; slot t reads frame t
    value: torch.Tensor,   # (T, H, W, Cv)
    *,
    radius: float,
    temperature: float = 1.0,
    topk: int = 10,
    normalize: bool = True,
    tile: int = 16,
    mask_shape: str = "circle",
    key_valid: Optional[Sequence[bool]] = None,
    compute_dtype: str = "float32",
    debug_passes: str = "abc",
) -> torch.Tensor:
    """K2 (K3 in 'high' and 'bfloat16'): the unbanked entry.  Normalises
    (if asked) and pads float32 query and keys on every call, casts them to
    the mode's dtype, then runs the same kernel as K1 with frame_idx 0..T-1.
    `debug_passes` 'a' or 'ab' runs a K5 cut-down instead (module
    docstring), counted in `cut_launches` only.  CPU tensors take the plain
    version; CUDA tensors take the kernel, or raise."""
    global unbanked_launches
    qpad, kpad, kw = _prepare_unbanked(query, key, value, key_valid, radius,
                                       temperature, topk, tile, normalize, mask_shape,
                                       compute_dtype)
    if _on_cpu(qpad, kpad, value):
        return topk_attention_banked_plain(qpad, kpad, value, debug_passes=debug_passes, **kw)
    out = _launch(qpad, kpad, value, debug_passes=debug_passes, **kw)
    if debug_passes != "abc":
        cut_launches[debug_passes] += 1
        return out
    unbanked_launches += 1
    mode_launches[compute_dtype] += 1
    return out


@torch.library.custom_op("fgvc_tpu_torch::topk_attention", mutates_args=())
def topk_attention_op(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    radius: float,
    temperature: float,
    topk: int,
    normalize: bool,
    tile: int,
    mask_shape: str,
    key_valid: Sequence[bool],
    compute_dtype: str,
) -> torch.Tensor:
    """K2 as a registered operator (``torch.ops.fgvc_tpu_torch.topk_attention``),
    which torch.export carries as one node of an exported program
    (core/export.py): ``topk_attention`` on contiguous inputs, counted as
    that wrapper counts.  CPU tensors take the plain version; CUDA tensors
    take the kernel, or raise."""
    # an exported program may hand over strided views: the wrapper normalises
    # the query over C, whose sum order follows the layout
    return topk_attention(
        query.contiguous(), key.contiguous(), value.contiguous(), radius=radius,
        temperature=temperature, topk=topk, normalize=normalize, tile=tile,
        mask_shape=mask_shape, key_valid=key_valid, compute_dtype=compute_dtype,
    )


@topk_attention_op.register_fake
def _(query, key, value, radius, temperature, topk, normalize, tile, mask_shape, key_valid,
      compute_dtype):
    # the (H, W, Cv) float32 result's shape only: touches no device
    return query.new_empty((*query.shape[:2], value.shape[-1]), dtype=torch.float32)


class _Params(ctypes.Structure):
    # field for field the TopkAttnParams struct of csrc/topk_attention.cu
    _fields_ = [
        *[(n, ctypes.c_int) for n in (
            "H", "W", "Hp", "Wp", "row0", "C", "Cv", "T", "tile", "halo", "win",
            "rows_total", "cols_total", "topk", "square",
        )],
        ("inv_temp", ctypes.c_float),
        ("rr", ctypes.c_float),
        ("radius", ctypes.c_float),
        ("frame_idx", ctypes.c_int * MAX_T),
        ("frame_bias", ctypes.c_float * MAX_T),
    ]


def _library(compute_dtype: str, cut: bool = False):
    """The extern "C" entry of a mode: the whole kernel, or (`cut`) the K5
    entry, which takes PASSES before the stream."""
    from fgvc_tpu_torch.ops.cuda.build import load

    lib = load("topk_attention")
    fn = getattr(lib, f"fgvc_topk_attention_{_ENTRY_SUFFIX[compute_dtype]}"
                      f"{'_cut' if cut else ''}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [_Params]
                       + ([ctypes.c_int] if cut else []) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(qpad, kpad, value, *, frame_idx, key_valid, H, W, radius,
            temperature, topk, tile, mask_shape, compute_dtype, row0=None,
            grid_rows=None, debug_passes="abc"):
    _check(qpad, kpad, value, frame_idx, key_valid, H, W, radius, topk, tile,
           mask_shape, compute_dtype, row0=row0, grid_rows=grid_rows)
    _check_cut(debug_passes, value.shape[3], radius, tile, row0)
    tensors = {"qpad": qpad, "kpad": kpad, "value": value}
    for name, x in tensors.items():
        if x.device.type != "cuda" or x.device != qpad.device:
            raise ValueError(
                f"{name} must lie on the CUDA device of qpad ({qpad.device}), "
                f"got {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    T, Cv, C = value.shape[0], value.shape[3], qpad.shape[2]
    if C % 16:
        raise ValueError(f"the kernel needs C % 16 == 0, got C={C}")
    if T > MAX_T:
        raise ValueError(f"the kernel takes at most {MAX_T} key slots, got {T}")
    if topk > MAX_TOPK:
        raise ValueError(f"the kernel takes topk <= {MAX_TOPK}, got {topk}")
    halo, _, Wp, rows_total, cols_total = bank_geometry(H, W, radius, tile, grid_rows)
    Hp = qpad.shape[0]  # the query grid, or the row block
    win = tile + 2 * halo
    ntiles = (Hp // tile) * (Wp // tile)
    if ntiles * T > 65535:
        raise ValueError(f"{ntiles} tiles x {T} slots exceed the launch grid")
    p = _Params(
        H, W, Hp, Wp, 0 if row0 is None else int(row0), C, Cv, T, tile, halo, win,
        rows_total, cols_total, topk, int(mask_shape == "square"), 1.0 / temperature,
        float(radius) * float(radius), float(radius),
    )
    for t in range(T):
        p.frame_idx[t] = int(frame_idx[t])
        p.frame_bias[t] = 0.0 if key_valid[t] else NEG
    if row0 is None:
        out = torch.empty((H, W, Cv), dtype=torch.float32, device=qpad.device)
    else:  # the kernel skips block rows at or past H: they stay 0
        out = torch.zeros((Hp, W, Cv), dtype=torch.float32, device=qpad.device)
    scratch = torch.empty(
        ntiles * tile * tile * T * win * win, dtype=torch.float32,
        device=qpad.device,
    )
    cut = debug_passes != "abc"
    fn = _library(compute_dtype, cut)
    with torch.cuda.device(qpad.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (qpad.data_ptr(), kpad.data_ptr(), value.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), p)
        err = fn(*args, DEBUG_PASSES[debug_passes], stream) if cut else fn(*args, stream)
    if err:
        raise RuntimeError(f"topk_attention kernel launch failed: CUDA error {err}")
    return out


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #
def _windows(x: torch.Tensor, nth: int, ntw: int, tile: int, win: int):
    """(R, Cc, D) padded map -> (nth * ntw, win * win, D) halo windows of
    the first nth tile rows."""
    sR, sC, sD = x.stride()
    D = x.shape[-1]
    w = x.as_strided((nth, ntw, win, win, D), (tile * sR, tile * sC, sR, sC, sD))
    return w.reshape(nth * ntw, win * win, D)


def topk_attention_banked_plain(
    qpad, kpad, value, *, frame_idx, key_valid, H, W, radius,
    temperature=1.0, topk=10, tile=16, mask_shape="circle", compute_dtype="float32",
    row0=None, grid_rows=None, debug_passes="abc",
):
    """K1's function (K3's in 'high' and 'bfloat16', K4's with row0 and
    grid_rows, K5's with debug_passes 'a' or 'ab') in plain PyTorch, written
    from the Pallas kernel's three passes (_make_kernel): masked affinities
    of every query tile, the top-k statistics by k + 1 distinct-value rounds,
    and the weighted value sum.  Runs on the device of its inputs, over rows
    of query tiles at most PLAIN_CHUNK_TILES tiles at a time (tiles are
    independent), so its temporaries stay near 1 GB each at the DAVIS VOS
    shapes."""
    _check(qpad, kpad, value, frame_idx, key_valid, H, W, radius, topk, tile,
           mask_shape, compute_dtype, row0=row0, grid_rows=grid_rows)
    # near_tie_rows_plain: one flag a pixel
    near = debug_passes in ("near", "near_stats")
    if not near:
        _check_cut(debug_passes, value.shape[3], radius, tile, row0)
    dev = qpad.device
    halo, gridH, Wp, _, _ = bank_geometry(H, W, radius, tile, grid_rows)
    g0 = 0 if row0 is None else int(row0)  # global row of qpad's first row
    Hp = qpad.shape[0]
    win = tile + 2 * halo
    nth, ntw = Hp // tile, Wp // tile
    S, FK = tile * tile, win * win
    T, Cv, C = value.shape[0], value.shape[3], qpad.shape[2]

    q = qpad.reshape(nth, tile, ntw, tile, C).permute(0, 2, 1, 3, 4)
    q = q.reshape(nth * ntw, S, C)

    # radius window over one frame window (S, FK), as the Pallas rbias
    f = torch.arange(FK, device=dev)
    wi, wj = (f // win).float(), (f % win).float()
    s = torch.arange(S, device=dev)
    qi, qj = (s // tile).float()[:, None], (s % tile).float()[:, None]
    dy, dx = wi[None] - halo - qi, wj[None] - halo - qj
    r = float(radius)
    if mask_shape == "square":
        in_range = (dy.abs() <= r) & (dx.abs() <= r)
    else:
        in_range = dy * dy + dx * dx < r * r
    rbias = torch.where(in_range, 0.0, NEG)

    vpad = torch.zeros(
        (T, gridH + 2 * halo, Wp + 2 * halo, Cv), dtype=value.dtype, device=dev
    )
    vpad[:, halo : halo + H, halo : halo + W] = value

    width = 1 if near else Cv
    out = torch.empty((nth * ntw, S, width), dtype=torch.float32, device=dev)
    rows = max(1, PLAIN_CHUNK_TILES // ntw)
    for i0 in range(0, nth, rows):
        i1 = min(nth, i0 + rows)
        n = torch.arange(i0 * ntw, i1 * ntw, device=dev)
        # image strip (N, 1, FK), as the Pallas kernel's in_img
        r0 = (g0 + (n // ntw) * tile).float()[:, None]
        c0 = ((n % ntw) * tile).float()[:, None]
        kgi, kgj = r0 + wi[None] - halo, c0 + wj[None] - halo
        in_img = (kgi >= 0) & (kgi <= H - 1) & (kgj >= 0) & (kgj <= W - 1)
        bias = rbias[None] + torch.where(in_img, 0.0, NEG)[:, None, :]
        kws = [_windows(kpad[int(frame_idx[t]), g0 + i0 * tile :], i1 - i0, ntw, tile, win)
               for t in range(T)]
        vws = [_windows(vpad[t, g0 + i0 * tile :], i1 - i0, ntw, tile, win)
               for t in range(T)]
        res = _plain_tiles(
            q[i0 * ntw : i1 * ntw], kws, vws, bias, key_valid, 1.0 / temperature, topk,
            compute_dtype, "a" if near else debug_passes,
        )
        if near:
            res = near_tie_rows(res, topk, stats=debug_passes == "near_stats")[..., None].float()
        elif debug_passes == "a":
            res = _pallas_columns(res, Cv, r0, c0, halo, win, H, W, key_valid[0])
        elif debug_passes == "ab":
            res = torch.nn.functional.pad(res, (0, max(Cv - N_STATS, 0)))[..., :Cv]
        out[i0 * ntw : i1 * ntw] = res
    out = out.reshape(nth, ntw, tile, tile, width).permute(0, 2, 1, 3, 4)
    out = out.reshape(Hp, Wp, width)[:, :W]
    if row0 is None:
        return out[:H].contiguous()
    out = out.contiguous()
    out[max(H - g0, 0):] = 0.0  # block rows at or past H, as the kernel leaves them
    return out


def _pallas_columns(a, Cv, r0, c0, halo, win, H, W, valid0):
    """K5 cut 'a': columns 0..Cv-1 of the Pallas affinity row, which lays
    slot 0's window out in rows of wpad = round_up(win, 8) columns, from the
    affinities a (N, S, T * win^2) of N tiles with origins r0, c0 (N, 1;
    global rows).  Columns in the Pallas over-pad (window row or column >=
    win) hold (NEG + border bias) + frame_bias[0], summed in the Pallas
    order; the product term vanishes in NEG's rounding."""
    wpad = _round_up(win, 8)
    col = torch.arange(Cv, device=a.device)
    ci, cj = col // wpad, col % wpad
    inside = (ci < win) & (cj < win)
    src = torch.where(inside, ci * win + cj, 0)
    kgi, kgj = r0 + ci.float() - halo, c0 + cj.float() - halo
    in_img = (kgi >= 0) & (kgi <= H - 1) & (kgj >= 0) & (kgj <= W - 1)
    over = torch.full_like(kgi, NEG) + torch.where(in_img, 0.0, NEG)
    over = over + (0.0 if valid0 else NEG)
    return torch.where(inside, a[..., src], over[:, None, :])


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """bf16(x) back in float32, rounded to nearest even."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x: torch.Tensor):
    """x = hi + lo to about 2^-16: hi = bf16(x), lo = bf16(x - hi)."""
    hi = _bf16_round(x)
    return hi, _bf16_round(x - hi)


def _products(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b of (N, M, K) and (N, K, P) in the mode's arithmetic."""
    if mode == "float32":
        return torch.bmm(a, b)
    if mode == "bfloat16":
        return torch.bmm(_bf16_round(a), _bf16_round(b))
    (ah, al), (bh, bl) = _split(a), _split(b)
    return torch.bmm(ah, bh) + torch.bmm(ah, bl) + torch.bmm(al, bh)


def _plain_tiles(q, kws, vws, bias, key_valid, inv_temp, topk, mode, passes="abc"):
    """The three passes over N query tiles: q (N, S, C); per slot, key
    windows (N, FK, C) and value windows (N, FK, Cv); bias (N, S, FK).
    `passes` 'a' returns the affinities (N, S, T * FK) after pass A, 'ab'
    pass B's statistics (N, S, 6): thresh, mmax, z, frac, n_above,
    cnt_at."""
    dev = q.device
    # pass A: one product per slot in the mode's arithmetic, so a frame in
    # two slots ties exactly
    raw = [_products(q, kw.transpose(1, 2), mode) for kw in kws]
    affs = [r * inv_temp + bias + (0.0 if key_valid[t] else NEG) for t, r in enumerate(raw)]
    a = torch.cat(affs, dim=-1)          # (N, S, T * FK)
    del affs
    if passes == "a":
        return a
    N, S, K = a.shape

    # pass B: round r finds the largest value strictly below round r-1's and
    # the count of elements >= round r-1's value
    vals, cges = [], []
    prev = torch.full((N, S, 1), 1e30, device=dev)
    for r in range(topk + 1):
        lt = a < prev
        if r > 0:
            cges.append(K - lt.sum(-1, keepdim=True).float())
        if r < topk:
            m = torch.where(lt, a, NEG).amax(-1, keepdim=True)
            vals.append(m)
            prev = m
    vals = torch.cat(vals, -1)
    cges = torch.cat(cges, -1)
    live = vals > NEG / 2
    mmax = vals[..., :1]
    cge_prev = torch.cat(
        [torch.zeros_like(cges[..., :1]), torch.where(live, cges, 0.0)[..., :-1]], -1
    )
    cnts = torch.clamp_min(cges - cge_prev, 0.0)
    inf = torch.tensor(float("inf"), device=dev)
    t1 = torch.where(live & (cges >= topk), vals, -inf).amax(-1, keepdim=True)
    t2 = torch.where(live, vals, inf).amin(-1, keepdim=True)
    thresh = torch.where(torch.isfinite(t1), t1, t2)
    thresh = torch.where(torch.isfinite(thresh), thresh, NEG)
    at_lane = live & (vals == thresh)
    n_above = torch.where(at_lane, cge_prev, 0.0).sum(-1, keepdim=True)
    cnt_at = torch.where(at_lane, cnts, 0.0).sum(-1, keepdim=True)
    frac = torch.minimum(torch.clamp_min(topk - n_above, 0.0), cnt_at) / torch.clamp_min(cnt_at, 1.0)
    e_vals = torch.exp(torch.clamp_max(vals - mmax, 0.0))
    z = torch.where(live & (vals > thresh), e_vals * cnts, 0.0).sum(-1, keepdim=True)
    z = z + frac * cnt_at * torch.exp(torch.clamp_max(thresh - mmax, 0.0)) * (thresh > NEG / 2)
    z = torch.clamp_min(z, 1e-30)
    if passes == "ab":
        return torch.cat([thresh, mmax, z, frac, n_above, cnt_at], -1)

    # pass C: weighted value sum, w computed in float32 and rounded with the
    # values per mode
    d = torch.sign(a - thresh)
    above = torch.clamp(d, 0.0, 1.0)
    at = (1.0 - d.abs()) * torch.clamp(torch.sign(a - NEG / 2) + 1.0, 0.0, 1.0)
    w = torch.exp(torch.clamp_max(a - mmax, 0.0)) * (above + frac * at)
    vw = torch.cat(vws, dim=1)           # (N, T * FK, Cv)
    return _products(w, vw, mode) / z    # (N, S, Cv)


def near_tie_rows(a: torch.Tensor, topk: int, tol: float = NEAR_TIE_TOL,
                  stats: bool = False) -> torch.Tensor:
    """(..., K) affinity rows (NEG-masked) -> (...) bool: the rows whose top-k
    selection another summation order can change, those whose k-th and
    (k+1)-th largest live elements lie within `tol` of each other.  That
    takes in a k-th value held by several keys of which the selection takes
    only some (the two are equal): keys that tie exactly in one order may
    not in another.  Rows with at most k live elements take every live key
    and are never near ties.  With `stats`, also the rows whose (k-1)-th and
    k-th largest live elements lie within `tol`: there the count at the
    threshold and the count above it can change (K5's cut 'ab'), though the
    selection does not."""
    if a.shape[-1] <= topk:
        return torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    top = torch.topk(a, topk + 1, dim=-1).values  # descending
    kth, next_ = top[..., topk - 1], top[..., topk]
    near = (next_ > NEG / 2) & (kth - next_ <= tol)
    if stats and topk > 1:
        near |= (kth > NEG / 2) & (top[..., topk - 2] - kth <= tol)
    return near


def near_tie_rows_plain(qpad, kpad, value, stats: bool = False, **kw) -> torch.Tensor:
    """near_tie_rows (with `stats`) of the plain version's affinities for the
    banked entry's arguments (K1, K3; K4 with row0 and grid_rows): (H, W)
    bool, or (hb, W) for a row block."""
    passes = "near_stats" if stats else "near"
    return topk_attention_banked_plain(qpad, kpad, value, debug_passes=passes, **kw)[..., 0] > 0


def near_tie_rows_plain_unbanked(query, key, value, *, radius, temperature=1.0, topk=10,
                                 normalize=True, tile=16, mask_shape="circle",
                                 key_valid=None, compute_dtype="float32", stats=False):
    """near_tie_rows_plain for the unbanked entry's arguments (K2, K5): (H,
    W) bool."""
    qpad, kpad, kw = _prepare_unbanked(query, key, value, key_valid, radius, temperature,
                                       topk, tile, normalize, mask_shape, compute_dtype)
    return near_tie_rows_plain(qpad, kpad, value, stats=stats, **kw)


def topk_attention_plain(
    query, key, value, *, radius, temperature=1.0, topk=10, normalize=True,
    tile=16, mask_shape="circle", key_valid=None, compute_dtype="float32",
    debug_passes="abc",
):
    """K2's function (K5's with debug_passes 'a' or 'ab') in plain PyTorch:
    the same per-call preparation as ``topk_attention``, then
    ``topk_attention_banked_plain``."""
    qpad, kpad, kw = _prepare_unbanked(query, key, value, key_valid, radius,
                                       temperature, topk, tile, normalize, mask_shape,
                                       compute_dtype)
    return topk_attention_banked_plain(qpad, kpad, value, debug_passes=debug_passes, **kw)
