"""Where a hand-written kernel's time goes: variants of its source with one
part cut out, timed on the card.

    python -m fgvc_tpu_torch.bench.ablate [--reps N]

Two kernels, each built as it is ('full') and with one part cut out:

* ``affinity_kernel`` (pass A of the top-k attention, csrc/topk_attention.cu)
  at the TAP-Vid shapes of ``pass_breakdown`` (128 x 128 x 256 query, 6 key
  slots, radius 15, circle), banked, in each compute mode, by its device ms
  per launch (torch.profiler): 'no products' skips the mma.sync products
  (staging, splitting, masks and the scratch write remain); 'no channel
  loop' skips the whole channel loop (the mask prologue, the epilogue and
  the scratch write remain).
* K6 'mxu' (csrc/mxu_vpu_overlap.cu) by CUDA events over back-to-back
  launches: 'no products' skips the mma.sync products (the key stream and
  the splits remain); 'no key refill' loads each warp's ring once and never
  refills it (no L2 key stream after the first stages).

A variant's output is wrong by design and is not checked: the variants
only time.  Each is compiled by nvcc with the flags of ops/cuda/build.py
into build/kernels/ and swapped in for the real library while it is timed.
One JSON line follows the table, with the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess

import numpy as np
import torch

from fgvc_tpu_torch.ops.cuda import build
from fgvc_tpu_torch.ops.cuda import mxu_vpu_overlap as k6
from fgvc_tpu_torch.ops.cuda import topk_attention as k1
from fgvc_tpu_torch.utils.env import card_info
from fgvc_tpu_torch.utils.profiler import device_ms_by_kernel, events_ms

# source -> {variant: (text cut out, what takes its place)}
CUTS = {
    "topk_attention": {
        "no products": ("      if (live) {\n", "      if (live == 0xffffffffu) {\n"),
        "no channel loop": ("  if (__syncthreads_or(live != 0)) {\n",
                            "  if (__syncthreads_or(live == 0xffffffffu)) {\n"),
    },
    "mxu_vpu_overlap": {
        "no products": ("        mma(d[i], as, bb);\n        mma(d[i], ab, bs);\n"
                        "        mma(d[i], ab, bb);\n", ""),
        "no key refill": ("    if (st + KSTAGES - 1 < NST) load(st + KSTAGES - 1);\n", ""),
    },
}
SIZE, C, T, CV = 128, 256, 6, 32
RADIUS, TEMPERATURE, TOPK, TILE = 15.0, 0.07, 10, 16


def variant_sources(name: str):
    """{variant: CUDA source} of csrc/<name>.cu, 'full' first; raises where
    a cut's text is not in the source."""
    src = (build.CSRC_DIR / f"{name}.cu").read_text()
    out = {"full": src}
    for variant, (old, new) in CUTS[name].items():
        if src.count(old) != 1:
            raise ValueError(f"the cut {variant!r} of {name}.cu is not in the source once")
        out[variant] = src.replace(old, new)
    return out


def _build(name: str, variant: str, text: str):
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = variant.replace(" ", "_")
    src = build.BUILD_DIR / f"ablate-{name}-{tag}.cu"
    lib = build.BUILD_DIR / f"libablate-{name}-{tag}.so"
    src.write_text(text)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


@contextlib.contextmanager
def _swapped(name: str, lib):
    """The wrappers of csrc/<name>.cu call `lib` inside the block."""
    old = build._loaded.get(name)
    build._loaded[name] = lib
    try:
        yield
    finally:
        if old is None:
            build._loaded.pop(name, None)
        else:
            build._loaded[name] = old


def time_affinity(reps: int):
    """{variant: {mode: affinity_kernel device ms per launch}}."""
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((T + 1, SIZE, SIZE, C), dtype=np.float32)).cuda()
    value = torch.from_numpy(rng.random((T, SIZE, SIZE, CV), dtype=np.float32)).cuda()
    halo, hp, wp, _, _ = k1.bank_geometry(SIZE, SIZE, RADIUS, TILE)
    res = {}
    for variant, text in variant_sources("topk_attention").items():
        res[variant] = {}
        with _swapped("topk_attention", _build("topk_attention", variant, text)):
            for mode in k1.COMPUTE_DTYPES:
                kpad = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode)
                kw = dict(qpad=kpad[T, halo:halo + hp, halo:halo + wp].contiguous(), kpad=kpad,
                          value=value, frame_idx=list(range(T)), key_valid=[True] * T, H=SIZE,
                          W=SIZE, radius=RADIUS, temperature=TEMPERATURE, topk=TOPK, tile=TILE,
                          compute_dtype=mode)
                k1.topk_attention_banked(**kw)  # warm-up
                by_kernel, _ = device_ms_by_kernel(
                    lambda: [k1.topk_attention_banked(**kw) for _ in range(reps)])
                res[variant][mode] = sum(
                    t for n, t in by_kernel.items() if "affinity_kernel" in n) / reps
    return res


def time_mxu(reps: int):
    """{variant: K6 'mxu' ms per launch}."""
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(np.asarray(rng.standard_normal(s), np.float32)).cuda()
            for s in ((k6.S, k6.C), (k6.T, k6.FK, k6.C)))
    res = {}
    for variant, text in variant_sources("mxu_vpu_overlap").items():
        with _swapped("mxu_vpu_overlap", _build("mxu_vpu_overlap", variant, text)):
            scratch = k6.new_scratch(q.device)
            k6.overlap("mxu", q, k, scratch)  # warm-up
            res[variant] = events_ms(lambda: k6.overlap("mxu", q, k, scratch), reps,
                                     back_to_back=True)
    return res


def run(reps: int = 20):
    if not torch.cuda.is_available():
        raise RuntimeError("ablate times CUDA kernels: it needs a card")
    card = card_info()
    print(f"ablate on {card}", flush=True)
    aff = time_affinity(max(reps // 4, 1))
    for variant, ms in aff.items():
        print(f"affinity_kernel {variant:16s}: " + ", ".join(f"{m} {t:.3f}" for m, t in ms.items())
              + " ms", flush=True)
    mxu = time_mxu(reps)
    for variant, ms in mxu.items():
        print(f"K6 mxu {variant:16s}: {ms:.4f} ms", flush=True)
    return {"tool": "ablate", "card": card, "affinity_device_ms": aff, "mxu_ms": mxu}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.reps)))


if __name__ == "__main__":
    main()
