"""Hold csrc/topk_attention.cu against another version of that source on the
card: every output of the kernel cases bit for bit, and select_kernel's
device time per launch in turns.

    python -m fgvc_tpu_torch.bench.compare_source --against OTHER.cu [--reps N]

OTHER.cu is, for example, an earlier commit's source saved under the
git-ignored build/ directory:

    git show <commit>:fgvc_tpu_torch/csrc/topk_attention.cu > build/other_topk_attention.cu

It is compiled with the flags of ops/cuda/build.py and swapped in for the
checkout's library while it runs, as bench/ablate.py swaps its variants.
The cases are those of chip_smoke.py's kernel phase, on the same seeds:
K1 circle at TAP-Vid shapes (128 x 128 x 256, 6 slots, radius 15, top-10,
32 values), K1 square and K2 at DAVIS VOS shapes (240 x 440 x 256, 5
values), for distinct key frames and the t = 1 tie, in every compute mode
(K3); the t = 1 tie through cut 'ab' (K5) of the unbanked entry; K4 row
blocks (circle at S = 2 and 3, square at S = 2 and 4); cut 'ab' at the
pass-breakdown tool's inputs; and the tie-heavy integer case
(``integer_tie_inputs``) through cut 'ab' and the whole kernel at both
shapes.  Each case runs once with each library; the outputs must be
``torch.equal``.  Then select_kernel's device ms per launch
(torch.profiler) at TAP-Vid (circle) and VOS (square) shapes in every mode,
in the order other, this, this, other.  One JSON line ends the output, with
the card's name and power limit.  Needs a card; exits 1 where a case
differs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from fgvc_tpu_torch.bench import ablate
from fgvc_tpu_torch.bench import pass_breakdown as pb
from fgvc_tpu_torch.ops.attention import l2_normalize
from fgvc_tpu_torch.ops.cuda import topk_attention as k1
from fgvc_tpu_torch.utils.env import card_info
from fgvc_tpu_torch.utils.profiler import device_ms_by_kernel

C, SLOTS, RADIUS, TOPK, TILE, TEMPERATURE = 256, 6, 15.0, 10, 16, 0.07
SHAPES = {"TAP-Vid": (128, 128, 32, "circle"), "VOS": (240, 440, 5, "square")}
ROW_SPLITS = {"circle": (2, 3), "square": (2, 4)}
FIDX = {"distinct": list(range(SLOTS)), "t1_tie": [0] * SLOTS}
VALID = {"distinct": [True] * SLOTS, "t1_tie": [True] + [False] * (SLOTS - 2) + [True]}
QFRAME = {"distinct": SLOTS, "t1_tie": 1}
# the tie-heavy case: integer features on a few of TIE_C channels
TIE_C, TIE_LIVE_CHANNELS, TIE_SPAN = 16, 4, 2
# the least limit of the tie-heavy case's z and output, relative
TIE_RTOL = 1e-6


def integer_tie_inputs(h, w, slots=SLOTS, cv=32, seed=0):
    """(query (h, w, 16), keys (slots, h, w, 16), values (slots, h, w, cv))
    float32 numpy arrays whose affinities every compute mode computes
    exactly at temperature 1 without normalisation: integers in
    [-TIE_SPAN, TIE_SPAN] on the first TIE_LIVE_CHANNELS channels, zero on
    the rest, so every product and sum is an exact small integer in TF32,
    bf16 and f32.  Most rows hold ties at their k-th value; the top-left
    quarter of every frame is flat (the largest feature vector), so its rows
    tie on up to thousands of keys at their largest value."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((slots + 1, h, w, TIE_C), np.float32)
    feats[..., :TIE_LIVE_CHANNELS] = rng.integers(
        -TIE_SPAN, TIE_SPAN + 1, (slots + 1, h, w, TIE_LIVE_CHANNELS))
    feats[:, : h // 4, : w // 4, :TIE_LIVE_CHANNELS] = TIE_SPAN
    value = rng.random((slots, h, w, cv), dtype=np.float32)
    return feats[slots], feats[:slots], value


def tie_heavy_limits(stats, mode, topk):
    """How far another summation order moves the tie-heavy case's z and
    output, whose affinities and statistics are exact: the float32 bound
    2 m 2^-24 of a sum of m terms, relative to the sum of their magnitudes,
    with at least TIE_RTOL.  z sums at most k + 1 terms (the distinct
    values above the threshold and the tie term); a row's output sums one
    term a selected key (three in 'high': hi.hi, hi.lo, lo.hi), n_above +
    cnt_at keys from `stats` (cut 'ab'), whose weights sum to z, so the
    limit is relative to max |v|.  Returns (z's relative limit, the output's
    limit per row over max |v|)."""
    terms = (stats[..., 4] + stats[..., 5]) * (3 if mode == "high" else 1)
    return (max(TIE_RTOL, 2.0 * (topk + 1) * 2.0 ** -24),
            torch.clamp(2.0 * terms * 2.0 ** -24, min=TIE_RTOL))


def tie_heavy_kwargs(mask_shape, mode, passes):
    """The unbanked entry's arguments for the tie-heavy case."""
    return dict(radius=RADIUS, temperature=1.0, topk=TOPK, normalize=False, tile=TILE,
                mask_shape=mask_shape, compute_dtype=mode, debug_passes=passes)


def kernel_cases():
    """Yield (label, fn): fn() runs the kernel once on one case."""
    rng = np.random.default_rng(0)
    for h, w, cv, entries in ((128, 128, 32, ("circle",)), (240, 440, 5, ("square", "unbanked"))):
        feats = torch.from_numpy(rng.standard_normal((SLOTS + 1, h, w, C), dtype=np.float32)).cuda()
        value = rng.random((SLOTS, h, w, cv), dtype=np.float32)
        values = {"distinct": torch.from_numpy(value).cuda(),
                  "t1_tie": torch.from_numpy(np.concatenate([value[:-1], value[:1]])).cuda()}
        halo, hp, wp, _, _ = k1.bank_geometry(h, w, RADIUS, TILE)
        nf = l2_normalize(feats)
        for mode in k1.COMPUTE_DTYPES:
            tie_value = torch.zeros((SLOTS, h, w, k1.N_STATS), device="cuda")
            key0 = nf[:1].expand(SLOTS, h, w, C).contiguous()
            yield f"{entries[0]} '{mode}' t1_tie cut 'ab'", lambda: k1.topk_attention(
                nf[QFRAME["t1_tie"]], key0, tie_value, radius=RADIUS, temperature=TEMPERATURE,
                topk=TOPK, normalize=False, tile=TILE, mask_shape=entries[0],
                key_valid=VALID["t1_tie"], compute_dtype=mode, debug_passes="ab")
            kpad = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode)
            for entry in entries:
                for case in FIDX:
                    if entry == "unbanked":
                        kw = dict(query=nf[QFRAME[case]], key=nf[FIDX[case]],
                                  value=values[case], radius=RADIUS, temperature=TEMPERATURE,
                                  topk=TOPK, normalize=False, tile=TILE, mask_shape="square",
                                  key_valid=VALID[case], compute_dtype=mode)
                        yield f"K2 '{mode}' {case}", lambda kw=kw: k1.topk_attention(**kw)
                        continue
                    kw = dict(qpad=kpad[QFRAME[case], halo:halo + hp, halo:halo + wp].contiguous(),
                              kpad=kpad, value=values[case], frame_idx=FIDX[case],
                              key_valid=VALID[case], H=h, W=w, radius=RADIUS,
                              temperature=TEMPERATURE, topk=TOPK, tile=TILE, mask_shape=entry,
                              compute_dtype=mode)
                    yield (f"K1 {entry} '{mode}' {case}",
                           lambda kw=kw: k1.topk_attention_banked(**kw))
            del kpad
        del feats, nf, values
        torch.cuda.empty_cache()

    rng = np.random.default_rng(1)
    for h, w, cv, shape in ((128, 128, 32, "circle"), (240, 440, 5, "square")):
        feats = torch.from_numpy(rng.standard_normal((SLOTS + 1, h, w, C), dtype=np.float32)).cuda()
        value = rng.random((SLOTS, h, w, cv), dtype=np.float32)
        values = {"distinct": torch.from_numpy(value).cuda(),
                  "t1_tie": torch.from_numpy(np.concatenate([value[:-1], value[:1]])).cuda()}
        halo, hp, wp, _, _ = k1.bank_geometry(h, w, RADIUS, TILE)
        for mode in k1.COMPUTE_DTYPES:
            for S in ROW_SPLITS[shape]:
                hb = -(-(-(-h // TILE) * TILE // S) // TILE) * TILE
                grid = S * hb
                tall = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode,
                                       grid_rows=grid)
                for case in (("distinct", "t1_tie") if S == 2 else ("distinct",)):
                    blocks = [dict(qpad=tall[QFRAME[case], halo + r0:halo + r0 + hb,
                                             halo:halo + wp].contiguous(),
                                   kpad=tall, row0=r0, grid_rows=grid, value=values[case],
                                   frame_idx=FIDX[case], key_valid=VALID[case], H=h, W=w,
                                   radius=RADIUS, temperature=TEMPERATURE, topk=TOPK, tile=TILE,
                                   mask_shape=shape, compute_dtype=mode)
                              for r0 in range(0, grid, hb)]
                    yield f"K4 {shape} '{mode}' S={S} {case}", lambda blocks=blocks: torch.cat(
                        [k1.topk_attention_banked(**b) for b in blocks])
                del tall
        del feats, values
        torch.cuda.empty_cache()

    inputs = pb.make_inputs(device="cuda")
    for mode in k1.COMPUTE_DTYPES:
        yield f"K5 cut 'ab' '{mode}'", lambda mode=mode: pb.call(inputs, mode, "ab")
    del inputs

    for name, (h, w, cv, shape) in SHAPES.items():
        q, k, v = (torch.from_numpy(x).cuda() for x in integer_tie_inputs(h, w, cv=cv))
        for mode in k1.COMPUTE_DTYPES:
            for passes in ("ab", "abc"):
                kw = tie_heavy_kwargs(shape, mode, passes)
                yield (f"tie-heavy {name} {shape} '{mode}' cut '{passes}'",
                       lambda kw=kw: k1.topk_attention(q, k, v, **kw))
        del q, k, v
        torch.cuda.empty_cache()


def compare(other_lib):
    """{label: (equal, rows that differ, max |diff|)} over kernel_cases()."""
    res = {}
    for label, fn in kernel_cases():
        with ablate.swapped("topk_attention", other_lib):
            ref = fn()
        out = fn()
        torch.cuda.synchronize()
        rows = (out != ref).reshape(-1, out.shape[-1]).any(-1)
        d = (out - ref).abs().max().item()
        res[label] = (torch.equal(out, ref), int(rows.sum()), d)
        print(f"{label}: {'equal' if res[label][0] else 'DIFFERENT'} "
              f"({res[label][1]} rows differ, max |diff| {d:.3e})", flush=True)
    return res


def select_ms(other_lib, reps):
    """{shape: {mode: [other, this, this, other]}}: select_kernel's device
    ms per launch of the banked entry on distinct key frames."""
    rng = np.random.default_rng(0)
    res = {}
    for name, (h, w, cv, shape) in SHAPES.items():
        feats = torch.from_numpy(rng.standard_normal((SLOTS + 1, h, w, C), dtype=np.float32)).cuda()
        value = torch.from_numpy(rng.random((SLOTS, h, w, cv), dtype=np.float32)).cuda()
        halo, hp, wp, _, _ = k1.bank_geometry(h, w, RADIUS, TILE)
        res[name] = {}
        for mode in k1.COMPUTE_DTYPES:
            kpad = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode)
            kw = dict(qpad=kpad[SLOTS, halo:halo + hp, halo:halo + wp].contiguous(), kpad=kpad,
                      value=value, frame_idx=FIDX["distinct"], key_valid=VALID["distinct"],
                      H=h, W=w, radius=RADIUS, temperature=TEMPERATURE, topk=TOPK, tile=TILE,
                      mask_shape=shape, compute_dtype=mode)
            times = []
            for lib in (other_lib, None, None, other_lib):
                with ablate.swapped("topk_attention", lib) if lib else contextlib.nullcontext():
                    k1.topk_attention_banked(**kw)  # warm-up
                    by_kernel, _ = device_ms_by_kernel(
                        lambda: [k1.topk_attention_banked(**kw) for _ in range(reps)])
                times.append(sum(t for n, t in by_kernel.items() if "select_kernel" in n) / reps)
            res[name][mode] = times
            print(f"select_kernel {name} '{mode}' device ms per launch (other, this, this, "
                  f"other): " + ", ".join(f"{t:.4f}" for t in times), flush=True)
            del kpad
        del feats, value
        torch.cuda.empty_cache()
    return res


def run(against: str, reps: int = 10):
    if not torch.cuda.is_available():
        raise RuntimeError("compare_source runs CUDA kernels: it needs a card")
    card = card_info()
    print(f"compare_source on {card}: this checkout against {against}", flush=True)
    other = ablate.build_variant("topk_attention", "other", Path(against).read_text())
    equal = compare(other)
    times = select_ms(other, reps)
    return {"tool": "compare_source", "card": card, "against": against,
            "cases": len(equal), "equal": sum(e for e, _, _ in equal.values()),
            "different": {k: v for k, v in equal.items() if not v[0]},
            "select_device_ms": times}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, help="another version of topk_attention.cu")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    res = run(args.against, args.reps)
    print(json.dumps(res))
    return 0 if not res["different"] else 1


if __name__ == "__main__":
    sys.exit(main())
