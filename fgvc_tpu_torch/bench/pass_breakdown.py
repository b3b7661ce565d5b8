"""Per-pass timing of the port's top-k attention kernel at TAP-Vid shapes.

    python -m fgvc_tpu_torch.bench.pass_breakdown [--reps N] [--device cuda|cpu] [--size N]
                                                  [--channels N]

Counterpart of tools/bench/pass_breakdown.py: the same seeded inputs (numpy
default_rng(0): q (128, 128, 256), k (6, 128, 128, 256), v (6, 128, 128, 32)
float32), radius 15, temperature 0.07, top-10, tile 16, the circle window,
and the same three compute modes, through the unbanked entry (K2,
``topk_attention``) and its K5 cut-downs.  Each of debug_passes 'a', 'ab' and
'abc' is timed by CUDA events (the median of REPS calls, after one warm-up;
REPS from --reps or the REPS environment variable, 20 by default), and the
tool prints, per mode, as the JAX tool does:

    A = t('a')    B = t('ab') - t('a')    C = t('abc') - t('ab')    total = t('abc')

then one JSON line with the same numbers, the device milliseconds per CUDA
kernel of one call of each cut (one torch.profiler pass each), and the card's
name and power limit.

What the split means on an H100.  The kernel (csrc/topk_attention.cu) runs
two CUDA kernels where the Pallas kernel ran one: pass A is affinity_kernel
(the masked affinities into a device-memory scratch), and passes B and C
share select_kernel, one block per query row: B is its one read of the row
into shared memory, the candidates above a bound and the fused
distinct-value rounds into the exact statistics; C is its compaction of the
keys at or above the threshold and the gather of their values.  Every cut
also pays the entry's per-call normalisation and padding, which falls in A;
cut 'a' adds a small emit kernel, and cut 'ab' stops select_kernel before
the selection.

With --device cpu the plain PyTorch versions run at --size x --size query
pixels and --channels feature channels (host clock; no device numbers).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Dict, Iterable

import numpy as np
import torch

from fgvc_tpu_torch.device import resolve_device
from fgvc_tpu_torch.ops.cuda.topk_attention import COMPUTE_DTYPES, topk_attention
from fgvc_tpu_torch.utils.env import card_info
from fgvc_tpu_torch.utils.profiler import device_ms_by_kernel, events_ms

CUTS = ("a", "ab", "abc")
SIZE, C, T, CV = 128, 256, 6, 32
RADIUS, TEMPERATURE, TOPK, TILE = 15.0, 0.07, 10, 16


def make_inputs(size: int = SIZE, device="cuda", channels: int = C):
    """The JAX tool's inputs (at --size x --size and --channels where
    smaller)."""
    rng = np.random.default_rng(0)
    shapes = ((size, size, channels), (T, size, size, channels), (T, size, size, CV))
    return tuple(torch.from_numpy(np.asarray(rng.standard_normal(s), np.float32)).to(device)
                 for s in shapes)


def call(inputs, mode: str, passes: str) -> torch.Tensor:
    q, k, v = inputs
    return topk_attention(q, k, v, radius=RADIUS, temperature=TEMPERATURE, topk=TOPK,
                          tile=TILE, compute_dtype=mode, debug_passes=passes)


def _host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def breakdown(inputs, modes: Iterable[str] = tuple(COMPUTE_DTYPES), reps: int = 20):
    """{mode: {'a', 'ab', 'abc': ms per call, 'A', 'B', 'C', 'total'}},
    printed per mode as the JAX tool prints it."""
    on_card = inputs[0].device.type == "cuda"
    res = {}
    for mode in modes:
        t = {}
        for passes in CUTS:
            fn = lambda: call(inputs, mode, passes)  # noqa: E731
            fn()  # warm-up (and the kernel's build)
            t[passes] = events_ms(fn, reps) if on_card else _host_ms(fn, reps)
        res[mode] = {**t, "A": t["a"], "B": t["ab"] - t["a"], "C": t["abc"] - t["ab"],
                     "total": t["abc"]}
        print(f"{mode:9s}: A {t['a']:6.2f}  B {t['ab'] - t['a']:6.2f}  "
              f"C {t['abc'] - t['ab']:6.2f}  total {t['abc']:6.2f} ms/frame", flush=True)
    return res


def kernel_ms(inputs, modes: Iterable[str] = tuple(COMPUTE_DTYPES)) -> Dict[str, Dict]:
    """{mode: {cut: {CUDA kernel: device ms}}}, one call of each cut under
    torch.profiler."""
    return {mode: {passes: device_ms_by_kernel(lambda: call(inputs, mode, passes))[0]
                   for passes in CUTS}
            for mode in modes}


def run(device="cuda", size: int = SIZE, reps: int = 20,
        modes: Iterable[str] = tuple(COMPUTE_DTYPES), channels: int = C) -> Dict:
    """Times, per-kernel device ms (on a card) and the card, as one dict."""
    dev = resolve_device(device)
    modes = tuple(modes)
    card = card_info() if dev.type == "cuda" else None
    print(f"pass_breakdown on {card or 'the CPU (plain versions)'}: {size}x{size}x{channels}, "
          f"T={T}, Cv={CV}, radius {RADIUS:g}, top-{TOPK}, tile {TILE}, median of {reps}",
          flush=True)
    inputs = make_inputs(size, dev, channels)
    with torch.no_grad():
        ms = breakdown(inputs, modes, reps)
        by_kernel = kernel_ms(inputs, modes) if dev.type == "cuda" else None
    return {"tool": "pass_breakdown", "device": str(dev), "card": card,
            "clock": "cuda events" if dev.type == "cuda" else "host",
            "size": size, "channels": channels, "reps": reps, "ms": ms,
            "device_ms_by_kernel": by_kernel}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=int(os.environ.get("REPS", "20")))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--size", type=int, default=SIZE,
                    help="query pixels per side (the JAX tool's 128 by default)")
    ap.add_argument("--channels", type=int, default=C,
                    help="feature channels (the JAX tool's 256 by default; a multiple of 16)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.size, args.reps, channels=args.channels)))


if __name__ == "__main__":
    main()
