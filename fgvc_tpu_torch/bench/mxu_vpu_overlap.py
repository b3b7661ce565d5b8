"""Does a Hopper SM overlap tensor-core products with independent SIMT work?

    python -m fgvc_tpu_torch.bench.mxu_vpu_overlap [--iters N]

Counterpart of tools/bench/mxu_vpu_overlap.py ``main()``: the three kinds of
kernel K6 (fgvc_tpu_torch/ops/cuda/mxu_vpu_overlap.py; 'mxu' products on the
tensor cores in 3xTF32, 'vpu' count/max rounds on SIMT warps, 'mixed' both
from independent warps of one block) on the tool's seeded inputs (numpy
default_rng(0): q (256, 256), k (6, 2304, 256) float32), each timed by CUDA
events over 30 launches queued back to back after one warm-up (the tool's
``bench``); then the serial expectation of 'mixed' and the overlap quality
with the tool's normalisation (1.0: the rounds hide fully behind the
products).  One JSON line follows with the same numbers, the time of
torch.matmul over the 6 frames at the same shape (float32, TF32 off) as the
yardstick of 'mxu', and the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from fgvc_tpu_torch.device import resolve_device
from fgvc_tpu_torch.ops.cuda import mxu_vpu_overlap as k6
from fgvc_tpu_torch.utils.env import card_info
from fgvc_tpu_torch.utils.profiler import events_ms

ITERS = 30


def make_inputs(device="cuda"):
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(np.asarray(rng.standard_normal(s), np.float32)).to(device)
                 for s in ((k6.S, k6.C), (k6.T, k6.FK, k6.C)))


def matmul_ms(q, k, iters: int = ITERS) -> float:
    """torch.matmul of q against the T frames of k, float32 with TF32 off:
    the library call for the 'mxu' kind's products."""
    kt = k.transpose(1, 2)
    with k6.tf32_off():
        torch.matmul(q, kt)  # warm-up
        return events_ms(lambda: torch.matmul(q, kt), iters, back_to_back=True)


def run(device="cuda", iters: int = ITERS):
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("mxu_vpu_overlap times the CUDA kernel: it needs a card")
    card = card_info()
    print(f"mxu_vpu_overlap on {card}: S={k6.S}, FK={k6.FK}, C={k6.C}, T={k6.T}, R={k6.R}",
          flush=True)
    q, k = make_inputs(dev)
    times = {}
    for kind in k6.KINDS:
        scratch = k6.new_scratch(dev)
        k6.overlap(kind, q, k, scratch)  # warm-up (and the kernel's build)
        times[kind] = events_ms(lambda: k6.overlap(kind, q, k, scratch), iters, back_to_back=True)
        print(f"{kind:6s}: {times[kind]:.3f} ms")
    quality = k6.overlap_quality(times)
    print(f"mixed expected if serial: {quality['expected_serial']:.3f} ms")
    print(f"overlap quality: {quality['overlap']:.2f} (1.0 = SIMT rounds fully hidden)")
    lib = matmul_ms(q, k, iters)
    print(f"torch.matmul over the {k6.T} frames (float32, TF32 off): {lib:.3f} ms", flush=True)
    return {"tool": "mxu_vpu_overlap", "device": str(dev), "card": card, "iters": iters,
            "ms": times, **quality, "matmul_ms": lib}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    print(json.dumps(run(iters=args.iters)))


if __name__ == "__main__":
    main()
