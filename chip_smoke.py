#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fgvc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--phases card,build,kernel,e2e,plain,vos,vos_plain,modes,sp,
                                    passes,overlap,profile,train]

Phases, each of which raises on failure (exit code != 0):
  card      the card's name and power limit (nvidia-smi);
  build     every CUDA source of fgvc_tpu_torch/csrc, one nvcc each, in
            parallel;
  kernel    each kernel against its plain PyTorch version on the card, in
            each compute mode ('float32': K1 and K2; 'high' and 'bfloat16':
            K3), for distinct key frames and for the first step's tie case
            (frame 0 in two valid slots): the banked entry with the circle
            window at TAP-Vid shapes (128 x 128 x 256 features, 6 key slots,
            radius 15, top-10, 32 values), and the banked entry with the
            square window and the unbanked entry at DAVIS VOS shapes (240 x
            440 x 256, 5 values).  The kernel multiplies on the tensor cores
            in an order the plain version cannot repeat, so each query
            pixel's output is held to its mode's limit (1e-4 in 'float32'
            and 'high'; 2^-7 max|v| in 'bfloat16', where a weight w one ulp
            apart can round to the neighbouring bf16 value), except near-tie
            rows: those whose plain k-th and (k+1)-th largest live
            affinities lie within 1e-4 of each other, where rounding can
            change a top-k member.  Rows beyond the limit must all be
            near-tie rows and at most 0.1% of the rows; their count is
            printed.  The tie case is exact: cut 'ab' (K5) of the unbanked
            entry on it gives even counts above and at the threshold on
            every row (each key ties with its copy).  The tie-heavy case
            (integer features on a few channels, no normalisation,
            temperature 1, a flat quarter in every frame) is exact in every
            mode at both shapes: every mode computes those affinities
            exactly, so cut 'ab''s thresh, mmax, frac, n_above and cnt_at
            equal the plain version's and z and the whole kernel's output
            agree within 1e-6 relative.  Then K4, the row
            blocks of spatial-parallel propagation, in each mode: TAP-Vid
            shapes (circle) in S = 2 and 3 blocks, VOS shapes (square) in
            S = 2 and 4, distinct frames (and the tie case at S = 2); each
            block against its plain version by the same rule, and the
            blocks, gathered and cut to the feature height, against the
            unsharded K1/K3 output with max |diff| = 0 (bit for bit); in
            'float32' each S's frame (its S blocks) timed against the
            unsharded call, and S = 2 per block launch, bounded by the
            block's own live pairs.  Each record of K1-K5 also carries
            affinity_kernel's and select_kernel's own device ms per launch
            (torch.profiler) and select_kernel's bound (its bytes: the
            scratch read once, the values, the output);
  e2e       run_task('davis') (the CLI's path) on two synthetic TAP-Vid
            pickles (48 frames, 256 x 256, 32 tracks) with seeded random
            weights at the full width of ResNet-18-d1; K1's launches must
            equal the frames propagated, K2's must be 0;
  plain     one of those videos again with the propagation forced through
            the plain version on the card: median trajectory |diff| <= 1e-3
            px and <D within 0.1;
  vos       eval_vos (the path of `--task vos`) on two synthetic DAVIS-like
            videos (24 frames, 480 x 854 resized to 480 x 880 as the reader
            does, three moving objects) with seeded random weights, once
            banked and once with save_mem: K1 (square) launches must equal the
            frames propagated on the banked run and K2's on the save_mem run,
            the other kernel 0; J&F finite; the two runs' label maps agree on
            >= 99.99% of pixels;
  vos_plain one of those videos cut to 8 frames, banked and save_mem, again
            with the propagation forced through the plain versions on the
            card: label maps agree with the kernels' on >= 99.999% of pixels
            and J&F-Mean within 1e-4;
  modes     K3 end to end: run_task('davis') on the e2e pickles with
            matmul_precision 'highest', 'high' and 'default', and eval_vos on
            one synthetic VOS video, banked and save_mem, in the same three;
            each run's launches must all be of its mode's kernel (one per
            frame propagated) and of its entry.  Against 'highest' on the same
            data: 'high' median trajectory |diff| <= 1e-2 px and <D within
            0.1; 'default' <D within 0.5 (the repo's fidelity bar,
            docs/precision_study.md); VOS J&F-Mean within 0.005.  Then that
            video cut to 8 frames in 'high' and 'default', through the
            kernels and the plain versions: label maps agree on >= 99.99%;
  sp        spatial-parallel propagation (--spatial-devices) on this card
            listed S times: run_task('davis') on the e2e pickles at S = 2,
            whose trajectories equal the unsharded tracker's (<= 1e-6 px) and
            whose <D equals the unsharded run's; one synthetic VOS video (24
            frames) banked at S = 2 and save_mem at S = 4 in 'highest', and
            save_mem at S = 2 in 'default', label maps 100% equal to the
            unsharded runs of the same mode.  Each run launches only K4, S per
            frame propagated; peak device memory beside the unsharded run's.
            With two cards or more, the TAP-Vid case again on two distinct
            cards (frame-parallel features at half the batch: trajectories
            within the plain phase's 1e-3 px median).
  passes    K5, the kernel's profiling cut-downs, through the profiling tool
            (python -m fgvc_tpu_torch.bench.pass_breakdown) at its shapes
            (TAP-Vid: 128 x 128 x 256, 6 slots, radius 15, top-10, 32
            values, circle) in each compute mode: the cut launches counted
            (one per call of each cut), the per-pass split printed; then each
            cut against its plain version on the card: cut 'a' masked
            affinities equal bit for bit and the live ones within 2e-5
            max|a|, once at the tool's 32 columns and once at Cv = 2304,
            every column of slot 0's window (live ones included); cut 'ab'
            n_above and cnt_at equal, thresh, mmax and frac within 1e-4, z
            within 1e-5 relative, on every row but near-tie rows (as in
            `kernel`, and rows whose (k-1)-th and k-th largest live
            affinities lie within 1e-4: the counts at and above the
            threshold move there);
  overlap   K6, the tensor-core / SIMT overlap microbenchmark, through its
            tool (python -m fgvc_tpu_torch.bench.mxu_vpu_overlap): the three
            kinds' times, the overlap quality and torch.matmul's time; then
            each kind against its plain version: 'mxu' max |diff| <= 1e-3,
            'mixed' - 'mxu' the plain version's integer counts, 'vpu' 10 * FK
            on every row;
  profile   python -m fgvc_tpu_torch.cli.test --task davis --profile DIR on
            one e2e pickle: the Chrome trace holds the propagate[0] and
            collect[0] spans and both CUDA kernels of K1;
  train     the mixed training recipe (fgvc_tpu_torch.apis.train.train_model
            on structured synthetic data): (a) the TrainConfig defaults at
            full width (crop 256, batch 4, radius 24, 'high', all three
            branches, ResNet-18-d1) for 8 steps with finite losses, the
            median step ms from step 3 on, the peak device memory, and 3
            steps under torch.profiler (busy share, top kernels); (b) one
            step at crop 64, radius 4, 'highest' on the card and on the CPU
            from the same weights, batch and dropped channels: losses within
            1e-4 relative, every gradient leaf within 1e-3 relative L2;
            (c) 2 steps + resume + 2 against 4 steps on the card: parameters
            and statistics within 1e-4; (d) mid-training validation
            (make_synthetic_val_fn) on the student: K1 launched, metrics
            finite.
The line before the last is a JSON object with each kernel's numbers; the last
line is {"ok": true, "device": {...}}.  Without a CUDA card, or without the
fgvc_tpu_torch package beside this file, it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 and TF32 on the tensor cores and HBM3 bandwidth; they
# assume the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# SIMT operations (compare, select, max, add) per second: the fp32 peak
# counts an FMA as two
PEAK_SIMT_OPS = PEAK_FP32_FLOPS / 2

# kernel against plain, per query pixel: 'float32' and 'high' to KERNEL_TOL,
# 'bfloat16' to BF16_TOL_REL * max|v|; rows beyond it must be near-tie rows
# (ops/cuda/topk_attention.py near_tie_rows), at most NEAR_TIE_SHARE of them
KERNEL_TOL = 1e-4
BF16_TOL_REL = 2.0 ** -7
NEAR_TIE_SHARE = 1e-3
# K5's cut 'a': live affinities against the plain version, relative to max|a|
AFF_RTOL = 2e-5
# K5's cut 'a' at every column of slot 0's window: Cv = round_up(win, 8)^2
# with win = 16 + 2 * 15 at the tool's shapes
FULL_WINDOW_CV = 48 * 48
# K5's cut 'ab': z against its plain version, relative
Z_RTOL = 1e-5
# the tie-heavy case (exact affinities): the least limit of z and the
# output, relative; only their summation orders differ from the plain
# version's (bench/compare_source.py tie_heavy_limits)
TIE_RTOL = 1e-6
# K6 'mxu' against float32 products: |out| is up to about 60, 3xTF32 keeps
# about 2^-21 of each product
MXU_TOL = 1e-3
# K4: blocks per frame in the kernel phase, per window
ROW_SPLITS = {"circle": (2, 3), "square": (2, 4)}
SP_TRAJ_TOL_PX = 1e-6
TRAJ_TOL_PX = 1e-3
DELTA_D_TOL = 0.1
# share of pixels on which two label maps must agree: banked against save_mem
# (features at batch 16 and at batch 1), and, in 'high' and 'default',
# kernels against plain versions (pass C sums in another order, and a
# bf16-rounded value mix moves a logit further); float32 kernels against
# plain versions agree closer (logits within 2e-7, so a label flips only at a
# near tie)
MASK_AGREE = 0.9999
PLAIN_MASK_AGREE = 0.99999
JF_TOL = 1e-4
# K3 against 'highest' (modes phase) and against its plain versions
PRECISIONS = ("highest", "high", "default")
MODE_TRAJ_TOL_PX = 1e-2
MODE_DELTA_D = {"high": 0.1, "default": 0.5}
MODE_JF_TOL = 0.005

# propagation settings of DAVIS_TEST_CFG (ResNet-18-d1 features, C = 256)
C = 256
SLOTS = 6
RADIUS = 15.0
TOPK = 10
TILE = 16
TEMPERATURE = 0.07
# TAP-Vid-DAVIS shapes (256 x 256 input), 32 point maps
H = W = 128
CV = 32
# DAVIS VOS shapes (480 x 880 input), 4 objects + background
VOS_H, VOS_W = 240, 440
VOS_CV = 5
VOS_T, VOS_ORIG, VOS_OBJECTS = 24, (480, 854), 3


def phase(name):
    print(f"== {name}", flush=True)


def card_info() -> str:
    from fgvc_tpu_torch.utils.env import card_info as query

    card = query()
    if card is None:
        raise RuntimeError("nvidia-smi reads no card")
    return card


def ptxas_usage(log):
    """[(kernel, 'registers, shared memory, spills')] from nvcc -Xptxas -v
    output, the kernels' names demangled where c++filt is at hand."""
    usage, name, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            usage.append([name, line.split("Used", 1)[1].strip() + "; " + spills])
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in usage),
                               capture_output=True, text=True, timeout=30).stdout.split("\n")
        for u, n in zip(usage, names):
            u[0] = n.replace("(anonymous namespace)::", "").split("(")[0] or u[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return usage


def build_kernels():
    from fgvc_tpu_torch.ops.cuda.build import CSRC_DIR, build_all

    names = sorted(p[:-3] for p in os.listdir(CSRC_DIR) if p.endswith(".cu"))
    t0 = time.time()
    logs = build_all(names)
    dt = time.time() - t0
    for name, log in logs.items():
        usage = ptxas_usage(log)
        print(f"built {name}.cu" + ("" if usage else ": cached"))
        for kernel, line in usage:
            print(f"  ptxas {kernel}: {line}")
    print(f"build time {dt:.1f} s for {len(names)} source(s)", flush=True)


def _events_ms(fn, reps):
    """Median device ms of fn() over reps calls (CUDA events)."""
    from fgvc_tpu_torch.utils.profiler import events_ms

    return events_ms(fn, reps)


def device_ms_by_kernel(fn):
    """Run fn under torch.profiler; {CUDA kernel name: device ms} and the
    wall ms of the run (empty dict where the profiler saw no device time)."""
    from fgvc_tpu_torch.utils.profiler import device_ms_by_kernel as profiled

    return profiled(fn)


def _top(ms_by_name, n=6):
    items = sorted(ms_by_name.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{name[:60]} {ms:.2f} ms" for name, ms in items)


def live_pairs(h, w, mask_shape, rows=None):
    """(query, key) pairs of one key slot inside the radius window and the
    image, over an h x w grid, or over its query rows [r0, r1) where `rows`
    is given (a row block)."""
    halo, r = int(RADIUS), RADIUS
    r0, r1 = (0, h) if rows is None else rows
    n = 0
    for dy in range(-halo, halo + 1):
        for dx in range(-halo, halo + 1):
            inside = (abs(dy) <= r and abs(dx) <= r) if mask_shape == "square" \
                else dy * dy + dx * dx < r * r
            if inside:  # query rows y in [r0, r1) with 0 <= y, y + dy < h
                ys = min(r1, h, h - dy) - max(r0, 0, -dy)
                n += max(ys, 0) * max(w - abs(dx), 0)
    return n


def attention_bound(h, w, mask_shape, key_valid, nbytes, mode="float32", rows=None):
    """Least time for one top-k attention call on these inputs: the larger
    of the live affinity products (in-window, in-image, valid-slot pairs,
    of the query rows `rows` where given; 2 * C flops each; 'float32' three
    TF32 products each (3xTF32) over the TF32 tensor-core peak, 'high' three
    bf16 products each and 'bfloat16' one over the bf16 tensor-core peak)
    and `nbytes` (each input read once, the output written once) over the
    HBM rate."""
    flops = 2.0 * C * live_pairs(h, w, mask_shape, rows) * sum(bool(v) for v in key_valid)
    if mode != "bfloat16":
        flops *= 3
    peak = PEAK_TF32_FLOPS if mode == "float32" else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


# the kernel phase's cases: key frames, slot validity and query frame of
# distinct key frames and of the step t = 1 (frame 0 in slot 0 and slot 5,
# the rest before the video)
FIDX = {"distinct": list(range(SLOTS)), "t1_tie": [0] * SLOTS}
VALID = {"distinct": [True] * SLOTS, "t1_tie": [True] + [False] * (SLOTS - 2) + [True]}
QFRAME = {"distinct": SLOTS, "t1_tie": 1}


# record tags of the compute modes
_TAG = {"float32": "f32", "high": "high", "bfloat16": "bf16"}


def record_key(entry, mode):
    """Record of an entry ('circle', 'square': banked; 'unbanked') in a
    compute mode."""
    if mode == "float32":
        return {"circle": "K1_circle", "square": "K1_square", "unbanked": "K2"}[entry]
    return f"K3_{'bf16' if mode == 'bfloat16' else mode}_{entry}"


def kernel_record(name, replaces, source="fgvc_tpu_torch/csrc/topk_attention.cu",
                  affinity=True):
    record = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
        "bound_ms": None, "bound_by": None,
        "library_ms": None,  # no single PyTorch call computes this function
    }
    if affinity:  # affinity_kernel's and select_kernel's own device ms per launch
        record.update(affinity_device_ms=None, select_device_ms=None, select_bound_ms=None)
    return record


def mode_limit(mode, value):
    """The kernel-against-plain limit of a compute mode on these values."""
    if mode == "bfloat16":
        return BF16_TOL_REL * float(value.abs().max())
    return KERNEL_TOL


def check_rows(label, out, ref, limit, near_fn):
    """Each query pixel's output (the last axis: its channels) against the
    plain version's: rows beyond `limit` must be near-tie rows of the plain
    affinities (near_fn(), a boolean map, asked only when some row is beyond
    the limit) and at most NEAR_TIE_SHARE of the rows.  Returns max |diff|."""
    d = (out - ref).abs().amax(-1)
    beyond = d > limit
    n_beyond, rows = int(beyond.sum()), beyond.numel()
    far = 0
    if n_beyond:
        far = int((beyond & ~near_fn().to(beyond.device)).sum())
    err = float(d.max())
    print(f"{label}: max |kernel - plain| = {err:.3e}; {n_beyond} of {rows} rows beyond "
          f"{limit:.3e} ({n_beyond - far} near-tie rows, {far} others; at most "
          f"{NEAR_TIE_SHARE * rows:.0f} near-tie rows allowed)", flush=True)
    if far or n_beyond > NEAR_TIE_SHARE * rows or not err == err:
        raise AssertionError(f"{label}: kernel disagrees with plain version")
    return err


def affinity_ms(by_kernel, reps, kernel="affinity_kernel"):
    """`kernel`'s device ms per launch from a torch.profiler table of `reps`
    launches (None where the profiler saw no device time)."""
    ms = [t for name, t in by_kernel.items() if kernel in name]
    return sum(ms) / reps if ms else None


def select_bound(h, w, cv, rows=None, values=True):
    """Least time of one select_kernel launch: its bytes over the HBM rate,
    each read once: the scratch rows of the h x w query pixels (of those in
    the row block [r0, r1) where `rows` is given; the grid's padding is not
    read), the values (their rows within the halo of the block) unless
    `values` is False (cut 'ab' reads none), and the output.  Its rounds and
    gather are a few hundred operations a row."""
    halo = int(RADIUS)
    win = TILE + 2 * halo
    r0, r1 = (0, h) if rows is None else rows
    n = max(min(r1, h) - r0, 0) * w  # query pixels read
    vrows = min(r1 + halo, h) - max(r0 - halo, 0)
    nbytes = 4.0 * (n * SLOTS * win * win + (SLOTS * vrows * w * cv if values else 0) + n * cv)
    return 1e3 * nbytes / PEAK_BYTES


def check_entry(label, record, kernel_fn, plain_fn, near_fn, cases, h, w, mask_shape, nbytes,
                mode):
    """Kernel against plain on each case {name: (kwargs, key_valid)}; the
    first case is timed and bounded."""
    import torch

    errs = []
    for i, (name, (kw, valid)) in enumerate(cases.items()):
        out = kernel_fn(**kw)
        ref = plain_fn(**kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label} {name}: non-finite output")
        errs.append(check_rows(f"{label} {name}", out, ref, mode_limit(mode, kw["value"]),
                               lambda: near_fn(**kw)))
        if i:
            continue
        del out, ref
        ms = _events_ms(lambda: kernel_fn(**kw), 20)
        plain_ms = _events_ms(lambda: plain_fn(**kw), 3)
        bound_ms, bound_by, flops = attention_bound(h, w, mask_shape, valid, nbytes, mode)
        halo = int(RADIUS)
        win = TILE + 2 * halo
        hp, wp = -(-h // TILE) * TILE, -(-w // TILE) * TILE
        dense = 2.0 * C * hp * wp * len(valid) * win * win  # the halo windows computed
        print(f"{label} {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP live, "
              f"{dense / 1e9:.2f} GFLOP in dense halo windows, {nbytes / 1e9:.3f} GB), "
              f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of live work"
              f"{'' if mode == 'bfloat16' else ' (3 products a pair)'}", flush=True)
        record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        reps = 5
        by_kernel, _ = device_ms_by_kernel(lambda: [kernel_fn(**kw) for _ in range(reps)])
        record.update(affinity_device_ms=affinity_ms(by_kernel, reps),
                      select_device_ms=affinity_ms(by_kernel, reps, "select_kernel"),
                      select_bound_ms=select_bound(h, w, kw["value"].shape[-1]))
        print(f"{label} device ms per launch by CUDA kernel (torch.profiler): " + (
            _top({n: t / reps for n, t in by_kernel.items()}) or "not measured")
            + f"; select_kernel bound {record['select_bound_ms']:.4f} ms (bytes)")
    record["max_abs_err"] = max(errs)


def check_tie_exact(label, query, key0, mask_shape, mode):
    """The t = 1 tie case through cut 'ab' (K5) of the unbanked entry: key
    frame 0 in slots 0 and T - 1, both valid.  Each key ties with its copy
    only if both slots sum its affinity bit for bit, so the counts above and
    at the threshold are even on every row."""
    import torch

    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    value = torch.zeros((SLOTS, *query.shape[:2], k1.N_STATS), device=query.device)
    stats = k1.topk_attention(query, key0.expand(SLOTS, *key0.shape[1:]).contiguous(), value,
                              radius=RADIUS, temperature=TEMPERATURE, topk=TOPK,
                              normalize=False, tile=TILE, mask_shape=mask_shape,
                              key_valid=VALID["t1_tie"], compute_dtype=mode, debug_passes="ab")
    odd = int((stats[..., 4:6] % 2 != 0).sum())
    print(f"{label} t1_tie exact: rows with an odd count above or at the threshold: {odd} "
          f"(must be 0)", flush=True)
    if odd:
        raise AssertionError(f"{label}: a frame in two slots does not tie exactly")


def check_tie_heavy():
    """The tie-heavy case with exact affinities (integer features on a few
    channels, no normalisation, temperature 1: bench/compare_source.py's
    integer_tie_inputs) through the unbanked entry in each compute mode, at
    TAP-Vid shapes (circle) and VOS shapes (square): every mode computes
    the affinities exactly, so the kernel's scratch equals the plain
    version's affinities.  Cut 'ab': thresh, mmax, frac, n_above and cnt_at
    equal the plain version's; z and the whole kernel's output within the
    float32 bound of their summation order (tie_heavy_limits: at least 1e-6
    relative, more on rows that sum thousands of tied keys)."""
    import torch

    from fgvc_tpu_torch.bench.compare_source import (
        integer_tie_inputs,
        tie_heavy_kwargs,
        tie_heavy_limits,
    )
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    for name, h, w, cv, shape in (("TAP-Vid", H, W, CV, "circle"),
                                  ("VOS", VOS_H, VOS_W, VOS_CV, "square")):
        q, k, v = (torch.from_numpy(x).cuda() for x in integer_tie_inputs(h, w, cv=cv))
        six = torch.zeros((SLOTS, h, w, k1.N_STATS), device=v.device)
        for mode in k1.COMPUTE_DTYPES:
            label = f"tie-heavy {name} {shape} '{mode}'"
            kw = tie_heavy_kwargs(shape, mode, "ab")  # all six statistics
            out, ref = (k1.topk_attention(q, k, six, **kw),
                        k1.topk_attention_plain(q, k, six, **kw))
            kw = tie_heavy_kwargs(shape, mode, "abc")
            mix, mix_ref = (k1.topk_attention(q, k, v, **kw),
                            k1.topk_attention_plain(q, k, v, **kw))
            torch.cuda.synchronize()
            exact = {n: int((out[..., i] != ref[..., i]).sum())
                     for i, n in ((0, "thresh"), (1, "mmax"), (3, "frac"), (4, "n_above"),
                                  (5, "cnt_at"))}
            z_rtol, mix_limit = tie_heavy_limits(ref, mode, TOPK)
            z_rel = ((out[..., 2] - ref[..., 2]).abs() / ref[..., 2].abs()).max().item()
            mix_rel = (mix - mix_ref).abs().amax(-1) / v.abs().max()
            over = int((mix_rel > mix_limit).sum())
            ties = int((ref[..., 5] > 1).sum())
            print(f"{label}: pixels differing from plain {exact} (all must be 0); z max rel "
                  f"diff {z_rel:.3e} (limit {z_rtol:.3e}); output max |diff| / max |v| "
                  f"{mix_rel.max().item():.3e}, {over} rows over their limit (at least "
                  f"{TIE_RTOL:.0e}, up to {mix_limit.max().item():.3e} on the row summing the "
                  f"most terms); {ties} of {h * w} rows tie at the threshold, at most "
                  f"{int(ref[..., 5].max())} keys", flush=True)
            if any(exact.values()) or not z_rel <= z_rtol or over:
                raise AssertionError(f"{label}: the kernel's statistics or output differ")
        del q, k, v, six
        torch.cuda.empty_cache()


def check_kernels(records):
    """In each compute mode: the banked entry with the circle window at
    TAP-Vid shapes, with the square window and the unbanked entry at DAVIS
    VOS shapes, each for distinct key frames (query frame 6) and the step
    t = 1 (frame 0 in slot 0 and slot 5, the rest before the video)."""
    import torch

    from fgvc_tpu_torch.ops.attention import l2_normalize
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    fidx, valid, qframe = FIDX, VALID, QFRAME
    rng = np.random.default_rng(0)
    for h, w, cv, entries in ((H, W, CV, ("circle",)),
                              (VOS_H, VOS_W, VOS_CV, ("square", "unbanked"))):
        feats = torch.from_numpy(rng.standard_normal((SLOTS + 1, h, w, C), dtype=np.float32)).cuda()
        value = rng.random((SLOTS, h, w, cv), dtype=np.float32)
        values = {"distinct": torch.from_numpy(value).cuda(),
                  "t1_tie": torch.from_numpy(np.concatenate([value[:-1], value[:1]])).cuda()}
        halo, hp, wp, rows_total, cols_total = k1.bank_geometry(h, w, RADIUS, TILE)
        # the save_mem scan's call, and the tie check's: pre-normalised
        # float32 features, raw keys
        nf = l2_normalize(feats)
        for mode in k1.COMPUTE_DTYPES:
            check_tie_exact(f"{'TAP-Vid' if h == H else 'VOS'} '{mode}'", nf[qframe["t1_tie"]],
                            nf[:1], entries[0], mode)
            kpad = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode)
            esize = kpad.element_size()  # query and bank bytes per element
            for entry in entries:
                key = record_key(entry, mode)
                if entry == "unbanked":
                    cases = {c: (dict(query=nf[qframe[c]], key=nf[fidx[c]], value=values[c],
                                      radius=RADIUS, temperature=TEMPERATURE, topk=TOPK,
                                      normalize=False, tile=TILE, mask_shape="square",
                                      key_valid=valid[c], compute_dtype=mode), valid[c])
                             for c in fidx}
                    # its inputs are the float32 query and keys, in every mode
                    nbytes = 4.0 * (h * w * C + SLOTS * h * w * C + SLOTS * h * w * cv
                                    + h * w * cv)
                    check_entry(f"{key} square", records[key], k1.topk_attention,
                                k1.topk_attention_plain, k1.near_tie_rows_plain_unbanked, cases,
                                h, w, "square", nbytes, mode)
                    continue
                cases = {c: (dict(qpad=kpad[qframe[c], halo:halo + hp, halo:halo + wp].contiguous(),
                                  kpad=kpad, value=values[c], frame_idx=fidx[c],
                                  key_valid=valid[c], H=h, W=w, radius=RADIUS,
                                  temperature=TEMPERATURE, topk=TOPK, tile=TILE,
                                  mask_shape=entry, compute_dtype=mode), valid[c])
                         for c in fidx}
                # query, the distinct key frames of the padded bank, values, output
                nbytes = (esize * (hp * wp * C + SLOTS * rows_total * cols_total * C)
                          + 4.0 * (SLOTS * h * w * cv + h * w * cv))
                check_entry(key, records[key], k1.topk_attention_banked,
                            k1.topk_attention_banked_plain, k1.near_tie_rows_plain, cases, h, w,
                            entry, nbytes, mode)
            del kpad
        del feats, nf, values
        torch.cuda.empty_cache()


def row_blocks(h, S):
    """(hb, gridH, row0 of each block): Tracker.row_blocks for S blocks."""
    hb = -(-(-(-h // TILE) * TILE // S) // TILE) * TILE
    return hb, S * hb, [i * hb for i in range(S)]


def check_row_blocks(records):
    """K4 in each compute mode: the banked entry's row blocks over a bank
    over-padded to S blocks, with the circle window at TAP-Vid shapes and
    the square window at VOS shapes; distinct key frames at every S and the
    t = 1 tie at S = 2.  Each block against its plain version; the gathered
    blocks against the unsharded call bit for bit.  In 'float32' a frame's
    S blocks are timed against the unsharded call; S = 2 per block launch
    (all S blocks over S), bounded by the mean of its blocks' bounds."""
    import torch

    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    rng = np.random.default_rng(1)
    for h, w, cv, shape in ((H, W, CV, "circle"), (VOS_H, VOS_W, VOS_CV, "square")):
        feats = torch.from_numpy(rng.standard_normal((SLOTS + 1, h, w, C), dtype=np.float32)).cuda()
        value = rng.random((SLOTS, h, w, cv), dtype=np.float32)
        values = {"distinct": torch.from_numpy(value).cuda(),
                  "t1_tie": torch.from_numpy(np.concatenate([value[:-1], value[:1]])).cuda()}
        halo, hp, wp, _, cols_total = k1.bank_geometry(h, w, RADIUS, TILE)
        record = records[f"K4_{shape}"]
        for mode in k1.COMPUTE_DTYPES:
            kpad = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode)
            kw = dict(H=h, W=w, radius=RADIUS, temperature=TEMPERATURE, topk=TOPK, tile=TILE,
                      mask_shape=shape, compute_dtype=mode)
            for S in ROW_SPLITS[shape]:
                hb, grid, row0s = row_blocks(h, S)
                tall = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode,
                                       grid_rows=grid)
                for case in (("distinct", "t1_tie") if S == 2 else ("distinct",)):
                    label = f"K4 {shape} '{mode}' S={S} {case}"
                    args = dict(value=values[case], frame_idx=FIDX[case], key_valid=VALID[case],
                                **kw)
                    unsharded = dict(qpad=kpad[QFRAME[case], halo:halo + hp,
                                               halo:halo + wp].contiguous(), kpad=kpad, **args)
                    full = k1.topk_attention_banked(**unsharded)
                    blocks = [dict(qpad=tall[QFRAME[case], halo + r0:halo + r0 + hb,
                                             halo:halo + wp].contiguous(),
                                   kpad=tall, row0=r0, grid_rows=grid, **args) for r0 in row0s]
                    outs = [k1.topk_attention_banked(**b) for b in blocks]
                    torch.cuda.synchronize()
                    if not all(torch.isfinite(o).all() for o in outs):
                        raise AssertionError(f"{label}: non-finite output")
                    limit = mode_limit(mode, args["value"])
                    errs = [check_rows(f"{label} block row0={b['row0']}", o,
                                       k1.topk_attention_banked_plain(**b), limit,
                                       lambda b=b: k1.near_tie_rows_plain(**b))
                            for o, b in zip(outs, blocks)]
                    gathered = torch.cat(outs)[:h]
                    d = (gathered - full).abs().max().item()
                    print(f"{label}: hb {hb}, grid {grid}; gathered vs unsharded "
                          f"max |diff| {d:.3e} (must be 0)", flush=True)
                    if not torch.equal(gathered, full):
                        raise AssertionError(f"{label}: gathered blocks differ from unsharded")
                    if mode == "float32":
                        record["max_abs_err"] = max(record["max_abs_err"] or 0.0, *errs)
                    if mode != "float32" or case != "distinct":
                        continue
                    del outs, gathered
                    # a frame on one card: its S blocks against the unsharded call
                    frame_ms = _events_ms(
                        lambda: [k1.topk_attention_banked(**b) for b in blocks], 20)
                    full_ms = _events_ms(lambda: k1.topk_attention_banked(**unsharded), 20)
                    print(f"{label}: a frame in {S} blocks {frame_ms:.3f} ms, unsharded "
                          f"{full_ms:.3f} ms ({100 * (frame_ms / full_ms - 1):+.1f}%; {grid} "
                          f"grid rows for {hp})", flush=True)
                    if S != 2:
                        continue
                    ms = frame_ms / S
                    plain_ms = _events_ms(
                        lambda: [k1.topk_attention_banked_plain(**b) for b in blocks], 3) / S
                    bounds = []
                    for r0 in row0s:
                        r1 = min(r0 + hb, h)
                        key_rows = hb + 2 * halo
                        # query block, its bank rows of each slot frame, its
                        # values' rows, the block's output
                        nbytes = 4.0 * (hb * wp * C + SLOTS * key_rows * cols_total * C
                                        + SLOTS * (min(r1 + halo, h) - max(r0 - halo, 0)) * w * cv
                                        + hb * w * cv)
                        bounds.append(attention_bound(h, w, shape, VALID[case], nbytes, mode,
                                                      rows=(r0, r0 + hb)))
                    bound_ms = sum(b[0] for b in bounds) / S
                    flops = sum(b[2] for b in bounds) / S
                    bound_by = bounds[0][1]
                    tiles = (hb // TILE) * (wp // TILE)
                    scratch = tiles * TILE * TILE * SLOTS * (TILE + 2 * halo) ** 2
                    print(f"{label}: kernel {ms:.3f} ms per block launch, plain {plain_ms:.3f} ms, "
                          f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP live per "
                          f"block); scratch {4.0 * scratch / 1e9:.2f} GB per block launch",
                          flush=True)
                    record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
                    reps = 5
                    by_kernel, _ = device_ms_by_kernel(
                        lambda: [k1.topk_attention_banked(**b) for _ in range(reps) for b in blocks])
                    record.update(
                        affinity_device_ms=affinity_ms(by_kernel, reps * S),
                        select_device_ms=affinity_ms(by_kernel, reps * S, "select_kernel"),
                        select_bound_ms=sum(select_bound(h, w, cv, rows=(r0, r0 + hb))
                                            for r0 in row0s) / S)
                    print(f"{label}: device ms per block launch (torch.profiler): affinity_kernel "
                          f"{record['affinity_device_ms']}, select_kernel "
                          f"{record['select_device_ms']} (bound {record['select_bound_ms']:.4f}, "
                          f"bytes)", flush=True)
                del tall
            del kpad
        del feats, values
        torch.cuda.empty_cache()


def _texture(rng, size):
    """Smooth random RGB texture (low-passed noise), uint8."""
    noise = rng.standard_normal((size, size, 3))
    f = np.fft.fft2(noise, axes=(0, 1))
    k = np.fft.fftfreq(size)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    tex = np.real(np.fft.ifft2(f * np.exp(-k2 * 2000.0)[..., None], axes=(0, 1)))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (tex * 255).astype(np.uint8)


def make_tapvid_pickles(root, n_videos=2, T=48, size=256, n_tracks=32, seed=0):
    """Per-video pickles of a texture panning at a random velocity; tracks
    follow the pan and are occluded outside the frame.  A quarter of the
    tracks are hidden until frame 10 or 20, so their queries form later
    groups."""
    rng = np.random.default_rng(seed)
    margin = 2 * T
    for vi in range(n_videos):
        tex = _texture(rng, size + 2 * margin)
        vel = rng.uniform(-1.5, 1.5, 2)
        off = np.round(np.arange(T)[:, None] * vel[None]).astype(int) + margin
        video = np.stack([tex[oy:oy + size, ox:ox + size] for ox, oy in off])
        p0 = rng.uniform(16, size - 16, (n_tracks, 2))
        pts = p0[:, None, :] - (off - off[0])[None].astype(np.float64)
        occ = (pts < 0).any(-1) | (pts > size - 1).any(-1)
        q = n_tracks // 8
        occ[-2 * q:-q, :10] = True
        occ[-q:, :20] = True
        with open(os.path.join(root, f"video_{vi:02d}.pkl"), "wb") as f:
            pickle.dump({"video": video, "points": (pts / size).astype(np.float32),
                         "occluded": occ}, f)


def frames_propagated(ds):
    total = 0
    for i in range(len(ds)):
        s = ds[i]
        T = len(s["video"])
        total += sum(T - int(t) - 1 for t in np.unique(s["query_points"][:, 0].astype(int)))
    return total


def check_metrics(metrics):
    for k in ("average_pts_within_thresh", "pts_within_1", "pts_within_16"):
        if not np.isfinite(metrics[k]):
            raise AssertionError(f"metric {k} is not finite: {metrics[k]}")


def check_launches(label, precision, expect, entry):
    """Every launch since the last reset was of `entry` ('banked',
    'unbanked' or 'row_block') in the compute mode of `precision`, `expect`
    of them (one per frame propagated, S per frame for row blocks)."""
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    mode = k1.pallas_compute_dtype(precision)
    counts = {"banked": k1.launches, "unbanked": k1.unbanked_launches,
              "row_block": k1.row_block_launches}
    got = (counts, dict(k1.mode_launches))
    want = ({e: expect if e == entry else 0 for e in counts},
            {m: expect if m == mode else 0 for m in k1.mode_launches})
    print(f"{label}: launches by entry {got[0]}, by mode {got[1]} (expected {expect} {entry})",
          flush=True)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def run_e2e(data_root, record):
    import torch

    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    expect = frames_propagated(ds)
    n_frames = sum(len(ds[i]["video"]) for i in range(len(ds)))

    k1.reset_launches()
    t0 = time.time()
    metrics = run_task("davis", data_root, device="cuda", seed=0)
    torch.cuda.synchronize()
    dt = time.time() - t0
    check_launches("e2e", "highest", expect, "banked")
    check_metrics(metrics)
    record["launches"] = expect
    print("TAP-Vid metrics (random weights): " + json.dumps(
        {k: metrics[k] for k in ("average_pts_within_thresh", "average_jaccard",
                                 "occlusion_accuracy", "pts_within_1", "pts_within_4",
                                 "pts_within_16")}))
    print(f"e2e: {len(ds)} videos, {n_frames} frames in {dt:.2f} s = "
          f"{n_frames / dt:.2f} frames/s (model build and data reading included)")
    return metrics


def run_plain_comparison(data_root):
    import torch

    import fgvc_tpu_torch.models.tracker as tracker_mod
    from fgvc_tpu_torch.apis.test import build_tracker
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    s = ds[0]
    tracker = build_tracker(seed=0, device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    feats, t_feat = timed(lambda: tracker.extract_features(s["video"]))
    n0 = k1.launches
    out_k, t_prop = timed(lambda: tracker.track_points(s["video"], s["query_points"], feats=feats))
    n_k = k1.launches - n0
    by_kernel, wall_ms = device_ms_by_kernel(
        lambda: tracker.track_points(s["video"], s["query_points"]))
    busy = sum(by_kernel.values())
    if busy:
        print(f"video 0 profiled (features + propagation + decode): wall {wall_ms:.1f} ms, "
              f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%); top kernels: "
              + _top(by_kernel))
    else:
        print("video 0 profile: device time not measured by torch.profiler")
    tracker_mod.topk_attention_banked = k1.topk_attention_banked_plain
    try:
        out_p, t_plain = timed(lambda: tracker.track_points(s["video"], s["query_points"], feats=feats))
    finally:
        tracker_mod.topk_attention_banked = k1.topk_attention_banked
    T = len(s["video"])
    print(f"video 0 ({T} frames): features {1e3 * t_feat:.1f} ms, propagation+decode "
          f"{1e3 * t_prop:.1f} ms with K1 ({n_k} launches), {1e3 * t_plain:.1f} ms "
          f"with the plain version")
    diff = np.abs(out_k["trajectories"] - out_p["trajectories"])
    med = float(np.median(diff))
    res = []
    for out in (out_k, out_p):
        res.append(ds.evaluate([{
            "trajectories_gt": s["trajectories"], "visibilities_gt": s["visibilities"],
            "trajectories_pred": out["trajectories"], "visibilities_pred": out["visibilities"],
            "query_points": s["query_points"],
        }])["average_pts_within_thresh"])
    print(f"kernel vs plain trajectories: median |diff| {med:.3e} px, max {diff.max():.3e} px; "
          f"<D {res[0]:.4f} vs {res[1]:.4f}", flush=True)
    if not med <= TRAJ_TOL_PX:
        raise AssertionError(f"median trajectory difference {med} px > {TRAJ_TOL_PX}")
    if not abs(res[0] - res[1]) <= DELTA_D_TOL:
        raise AssertionError(f"<D differs by {abs(res[0] - res[1])} > {DELTA_D_TOL}")


class SyntheticDavis:
    """DAVIS-like videos made in numpy: a panning texture at the original
    size with VOS_OBJECTS textured ellipses moving over it (a later object
    hides an earlier one), resized to 480 x 880 as the DAVIS reader does.
    The reader's interface: __len__, __getitem__ and score_video, which
    also keeps each video's predicted label maps."""

    def __init__(self, n_videos=2, T=VOS_T, orig=VOS_ORIG, seed=0):
        from fgvc_tpu_torch.datasets.davis_vos import INPUT_SIZE, resize_frames

        rng = np.random.default_rng(seed)
        h0, w0 = orig
        orig = np.array(orig, dtype=np.float64)
        margin = 2 * T
        yy, xx = np.mgrid[:h0, :w0]
        self.videos, self.gt, self.preds = [], [], {}
        for _ in range(n_videos):
            tex = _texture(rng, max(h0, w0) + 2 * margin)
            vel = rng.uniform(-1.5, 1.5, 2)
            off = np.round(np.arange(T)[:, None] * vel[None]).astype(int) + margin
            frames = np.stack([tex[oy:oy + h0, ox:ox + w0] for ox, oy in off])
            labels = np.zeros((T, h0, w0), np.uint8)
            for k in range(1, VOS_OBJECTS + 1):
                sprite = _texture(rng, 256)
                c0 = rng.uniform(0.3, 0.7, 2) * orig
                v = rng.uniform(-0.2, 0.2, 2) * orig / T
                ry, rx = rng.uniform(0.08, 0.18, 2) * orig
                for t in range(T):
                    cy, cx = c0 + t * v
                    inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
                    frames[t][inside] = sprite[(yy[inside] - int(cy)) % 256,
                                               (xx[inside] - int(cx)) % 256]
                    labels[t][inside] = k
            self.videos.append(resize_frames(frames, INPUT_SIZE))
            self.gt.append(labels)

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, i):
        return {"sequence": f"synthetic_{i}", "video": self.videos[i],
                "first_mask": self.gt[i][0], "original_shape": self.gt[i].shape[1:],
                "num_objects": int(self.gt[i][0].max())}

    def score_video(self, i, pred):
        from fgvc_tpu_torch.datasets.davis_vos import score_masks

        self.preds[i] = pred
        return score_masks(self.gt[i], pred)


def _agreement(a, b):
    return float(np.mean(np.concatenate([x.ravel() for x in a]) ==
                         np.concatenate([x.ravel() for x in b])))


def run_vos(ds, records, precision="highest"):
    """eval_vos banked (the banked entry, square) and with save_mem (the
    unbanked entry) on `ds` in one matmul_precision; returns {path:
    (J&F-Mean, label maps, peak device GB)}."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, eval_vos
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    expect = sum(len(v) - 1 for v in ds.videos)
    n_frames = sum(len(v) for v in ds.videos)
    out = {}
    kernel_mode = k1.pallas_compute_dtype(precision)
    for path, save_mem in (("banked", False), ("save_mem", True)):
        mode = f"{precision} {path}"
        tracker = build_tracker(dataclasses.replace(DAVIS_TEST_CFG, save_mem=save_mem,
                                                    matmul_precision=precision),
                                seed=0, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        k1.reset_launches()
        t0 = time.time()
        res = eval_vos(tracker, ds)
        torch.cuda.synchronize()
        dt = time.time() - t0
        entry = "unbanked" if save_mem else "banked"
        check_launches(f"vos {mode}", precision, expect, entry)
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"vos {mode}: J&F (random weights) " + json.dumps(res))
        print(f"vos {mode}: {len(ds)} videos, {n_frames} frames at 480 x 880 in {dt:.2f} s "
              f"= {n_frames / dt:.2f} frames/s (model build excluded, scoring included); "
              f"peak device memory {peak:.2f} GB", flush=True)
        if not np.isfinite(res["J&F-Mean"]):
            raise AssertionError(f"vos {mode}: J&F-Mean is not finite: {res}")
        records[record_key("unbanked" if save_mem else "square", kernel_mode)]["launches"] = expect
        out[path] = (res["J&F-Mean"], [ds.preds[i] for i in range(len(ds))], peak)
        if path == "banked":
            s = ds[0]
            by_kernel, wall_ms = device_ms_by_kernel(lambda: tracker.track_masks(
                s["video"], s["first_mask"], tuple(s["original_shape"]), s["num_objects"]))
            busy = sum(by_kernel.values())
            print(f"vos video 0 profiled (features + propagation + decode, {len(s['video'])} "
                  f"frames): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
                  f"({100 * busy / wall_ms:.1f}%); top kernels: " + (_top(by_kernel) or "not measured"))
        del tracker
        torch.cuda.empty_cache()
    # float32 holds the two paths together; bf16 rounding of features that
    # were computed at batch 16 and at batch 1 may move a label near a tie
    limit = MASK_AGREE if precision == "highest" else None
    agree = _agreement(out["banked"][1], out["save_mem"][1])
    print(f"vos {precision} banked vs save_mem label maps: {100 * agree:.5f}% of pixels "
          f"agree (limit {'none' if limit is None else f'{100 * limit}%'})", flush=True)
    if limit is not None and not agree >= limit:
        raise AssertionError(f"banked and save_mem masks agree on {agree} < {limit}")
    return out


def run_vos_plain(ds, n_frames=8, precision="highest", agree_limit=PLAIN_MASK_AGREE,
                  jf_tol=JF_TOL):
    """Video 0 cut to n_frames, banked and save_mem, through the kernels
    and through the plain versions on the card, in one matmul_precision;
    label maps agree on >= agree_limit of pixels and J&F-Mean within jf_tol
    (where given)."""
    import dataclasses

    import torch

    import fgvc_tpu_torch.models.tracker as tracker_mod
    from fgvc_tpu_torch.apis.test import build_tracker
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.core.metrics.vos import aggregate_jf
    from fgvc_tpu_torch.datasets.davis_vos import score_masks
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    s = ds[0]
    video, gt = s["video"][:n_frames], ds.gt[0][:n_frames]
    args = (video, s["first_mask"], tuple(s["original_shape"]), s["num_objects"])
    for save_mem in (False, True):
        tracker = build_tracker(dataclasses.replace(DAVIS_TEST_CFG, save_mem=save_mem,
                                                    matmul_precision=precision),
                                seed=0, device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        out_k = tracker.track_masks(*args)
        t_k = time.time() - t0
        tracker_mod.topk_attention_banked = k1.topk_attention_banked_plain
        tracker_mod.topk_attention = k1.topk_attention_plain
        try:
            t0 = time.time()
            out_p = tracker.track_masks(*args)
            t_p = time.time() - t0
        finally:
            tracker_mod.topk_attention_banked = k1.topk_attention_banked
            tracker_mod.topk_attention = k1.topk_attention
        agree = _agreement([out_k], [out_p])
        jf = [aggregate_jf([score_masks(gt, o)])["J&F-Mean"] for o in (out_k, out_p)]
        mode = f"{precision} {'save_mem' if save_mem else 'banked'}"
        print(f"vos_plain {mode} ({n_frames} frames): kernel {1e3 * t_k:.1f} ms, plain "
              f"{1e3 * t_p:.1f} ms; label maps agree on {100 * agree:.5f}% of pixels; "
              f"J&F-Mean {jf[0]:.6f} vs {jf[1]:.6f} (|diff| {abs(jf[0] - jf[1]):.3e})", flush=True)
        if not agree >= agree_limit:
            raise AssertionError(f"vos_plain {mode}: masks agree on {agree} < {agree_limit}")
        if jf_tol is not None and not abs(jf[0] - jf[1]) <= jf_tol:
            raise AssertionError(f"vos_plain {mode}: J&F-Mean differs by {abs(jf[0] - jf[1])}")
        del tracker
        torch.cuda.empty_cache()


def run_modes_tapvid(data_root, records):
    """run_task('davis') in each matmul_precision on the same pickles and
    weights; 'high' and 'default' held to 'highest'."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, run_task
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    expect = frames_propagated(ds)
    n_frames = sum(len(ds[i]["video"]) for i in range(len(ds)))
    delta_d, traj = {}, {}
    for precision in PRECISIONS:
        cfg = dataclasses.replace(DAVIS_TEST_CFG, matmul_precision=precision)
        k1.reset_launches()
        t0 = time.time()
        metrics = run_task("davis", data_root, test_cfg=cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        dt = time.time() - t0
        check_launches(f"modes davis {precision}", precision, expect, "banked")
        check_metrics(metrics)
        records[record_key("circle", k1.pallas_compute_dtype(precision))]["launches"] = expect
        delta_d[precision] = metrics["average_pts_within_thresh"]
        print(f"modes davis {precision}: <D {delta_d[precision]:.4f}, AJ "
              f"{metrics['average_jaccard']:.4f}; {n_frames} frames in {dt:.2f} s = "
              f"{n_frames / dt:.2f} frames/s (model build and data reading included)", flush=True)
        # the trajectories, after the counts were read
        tracker = build_tracker(cfg, seed=0, device="cuda")
        traj[precision] = np.concatenate([
            tracker.track_points(ds[i]["video"], ds[i]["query_points"])["trajectories"].ravel()
            for i in range(len(ds))])
        del tracker
    for precision in ("high", "default"):
        diff = np.abs(traj[precision] - traj["highest"])
        med, dd = float(np.median(diff)), abs(delta_d[precision] - delta_d["highest"])
        print(f"modes davis {precision} vs highest: trajectories median |diff| {med:.3e} px, "
              f"max {diff.max():.3e} px; <D {delta_d[precision]:.4f} vs "
              f"{delta_d['highest']:.4f} (|diff| {dd:.4f}, limit {MODE_DELTA_D[precision]})",
              flush=True)
        if precision == "high" and not med <= MODE_TRAJ_TOL_PX:
            raise AssertionError(f"'high' trajectories: median |diff| {med} > {MODE_TRAJ_TOL_PX}")
        if not dd <= MODE_DELTA_D[precision]:
            raise AssertionError(f"{precision!r} <D differs by {dd} > {MODE_DELTA_D[precision]}")


def run_modes_vos(records):
    """eval_vos on one synthetic video in each matmul_precision, banked and
    save_mem, against 'highest'; then that video's first 8 frames through
    the kernels and the plain versions in 'high' and 'default'."""
    ds = SyntheticDavis(n_videos=1)
    runs = {precision: run_vos(ds, records, precision) for precision in PRECISIONS}
    for precision in ("high", "default"):
        for path in ("banked", "save_mem"):
            jf, preds, peak = runs[precision][path]
            jf0, preds0, peak0 = runs["highest"][path]
            print(f"modes vos {precision} {path} vs highest: J&F-Mean {jf:.6f} vs {jf0:.6f} "
                  f"(|diff| {abs(jf - jf0):.3e}, limit {MODE_JF_TOL}); label maps agree on "
                  f"{100 * _agreement(preds, preds0):.4f}% of pixels; peak device memory "
                  f"{peak:.2f} GB vs {peak0:.2f} GB ({peak - peak0:+.2f} GB)", flush=True)
            if not abs(jf - jf0) <= MODE_JF_TOL:
                raise AssertionError(f"vos {precision} {path}: J&F-Mean differs by {abs(jf - jf0)}")
    for precision in ("high", "default"):
        run_vos_plain(ds, precision=precision, agree_limit=MASK_AGREE, jf_tol=None)


def _peak_gb_of(fn):
    """(fn(), peak device GB allocated while it ran)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9


def _trajectories(tracker, ds):
    return np.concatenate([tracker.track_points(ds[i]["video"], ds[i]["query_points"])
                           ["trajectories"].ravel() for i in range(len(ds))])


def run_sp_tapvid(data_root, record, card, e2e_metrics=None):
    """run_task('davis', spatial_devices=[card] * 2) on the e2e pickles:
    only K4 launches, two per frame propagated; <D equal to the unsharded
    run's; trajectories of the row-block tracker equal to the unsharded
    tracker's; with two cards or more, the same on two distinct cards."""
    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, run_task
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    expect = frames_propagated(ds)
    if e2e_metrics is None:
        e2e_metrics = run_task("davis", data_root, device=card, seed=0)
    S = 2
    k1.reset_launches()
    t0 = time.time()
    metrics, peak = _peak_gb_of(lambda: run_task("davis", data_root, seed=0,
                                                 spatial_devices=[card] * S))
    dt = time.time() - t0
    check_launches(f"sp davis S={S}", "highest", S * expect, "row_block")
    check_metrics(metrics)
    record["launches"] = S * expect
    d0, d1 = e2e_metrics["average_pts_within_thresh"], metrics["average_pts_within_thresh"]
    print(f"sp davis S={S} on one card: <D {d1:.6f} vs unsharded {d0:.6f}; {dt:.2f} s "
          f"(model build and data reading included); peak device memory {peak:.2f} GB",
          flush=True)
    if d1 != d0:
        raise AssertionError(f"sp davis: <D {d1} differs from the unsharded {d0}")
    single, peak0 = _peak_gb_of(lambda: _trajectories(build_tracker(seed=0, device=card), ds))
    sp, peak1 = _peak_gb_of(lambda: _trajectories(
        build_tracker(seed=0, spatial_devices=[card] * S), ds))
    diff = np.abs(sp - single)
    print(f"sp davis S={S} trajectories vs unsharded: max |diff| {diff.max():.3e} px "
          f"(limit {SP_TRAJ_TOL_PX}); peak device memory over both videos {peak1:.2f} GB vs "
          f"{peak0:.2f} GB unsharded", flush=True)
    if not diff.max() <= SP_TRAJ_TOL_PX:
        raise AssertionError(f"sp davis: trajectories differ by {diff.max()} px")
    if torch.cuda.device_count() < 2:
        print("sp davis on distinct cards: not run (this machine has one card)", flush=True)
        return
    k1.reset_launches()
    multi = _trajectories(build_tracker(seed=0, spatial_devices=S), ds)
    check_launches(f"sp davis S={S} on {S} cards", "highest", S * expect, "row_block")
    diff = np.abs(multi - single)
    print(f"sp davis S={S} on {S} distinct cards: trajectories vs unsharded median |diff| "
          f"{np.median(diff):.3e} px, max {diff.max():.3e} px (median limit {TRAJ_TOL_PX})",
          flush=True)
    if not np.median(diff) <= TRAJ_TOL_PX:
        raise AssertionError(f"sp davis on {S} cards: median |diff| {np.median(diff)} px")


def run_sp_vos(record, card):
    """One synthetic VOS video through eval_vos, unsharded and on `card`
    listed S times: banked at S = 2 and save_mem at S = 4 in 'highest',
    save_mem at S = 2 in 'default'; label maps 100% equal, only K4 launches
    in the row-block runs (S per frame propagated)."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, eval_vos
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = SyntheticDavis(n_videos=1)
    frames = len(ds.videos[0]) - 1
    record["launches"] = 0
    for precision, save_mem, S in (("highest", False, 2), ("highest", True, 4),
                                   ("default", True, 2)):
        cfg = dataclasses.replace(DAVIS_TEST_CFG, save_mem=save_mem, matmul_precision=precision)
        path = f"{precision} {'save_mem' if save_mem else 'banked'}"
        runs = {}
        for spatial in (None, [card] * S):
            tracker = build_tracker(cfg, seed=0, device=card, spatial_devices=spatial)
            k1.reset_launches()
            t0 = time.time()
            res, peak = _peak_gb_of(lambda: eval_vos(tracker, ds))
            dt = time.time() - t0
            if spatial is None:
                check_launches(f"sp vos {path} unsharded", precision, frames,
                               "unbanked" if save_mem else "banked")
            else:
                check_launches(f"sp vos {path} S={S}", precision, S * frames, "row_block")
                if precision == "highest":
                    record["launches"] += S * frames
            runs[spatial is None] = (res["J&F-Mean"], ds.preds[0], peak, dt)
            del tracker
            torch.cuda.empty_cache()
        (jf0, pred0, peak0, dt0), (jf1, pred1, peak1, dt1) = runs[True], runs[False]
        agree = _agreement([pred1], [pred0])
        print(f"sp vos {path} S={S} vs unsharded: label maps agree on {100 * agree:.5f}% of "
              f"pixels (must be 100%); J&F-Mean {jf1:.6f} vs {jf0:.6f}; {dt1:.2f} s vs "
              f"{dt0:.2f} s (scoring included); peak device memory {peak1:.2f} GB vs "
              f"{peak0:.2f} GB ({peak1 - peak0:+.2f} GB)", flush=True)
        if agree != 1.0:
            raise AssertionError(f"sp vos {path} S={S}: label maps differ from the unsharded run")


def check_cut(label, out, ref, passes, near_fn):
    """K5 cut `passes` against its plain version; returns max |diff|.  Cut
    'a': masked affinities equal bit for bit, live ones within AFF_RTOL *
    max|a|.  Cut 'ab': on every row but near-tie rows (near_fn(), asked only
    where a row differs; at most NEAR_TIE_SHARE of the rows) n_above and
    cnt_at equal, thresh, mmax and frac within KERNEL_TOL, z within Z_RTOL
    relative; the columns past the six statistics 0."""
    import torch

    neg = -1e30
    if passes == "a":
        masked = ref <= neg / 2
        if not torch.equal(out <= neg / 2, masked) or not torch.equal(out[masked], ref[masked]):
            raise AssertionError(f"{label}: masked affinities differ from the plain version")
        live = (out[~masked] - ref[~masked]).abs()
        err = live.max().item() if live.numel() else 0.0
        limit = AFF_RTOL * (ref[~masked].abs().max().item() if live.numel() else 0.0)
        print(f"{label}: {live.numel()} live and {int(masked.sum())} masked columns; masked "
              f"equal; live max |kernel - plain| = {err:.3e} (limit {limit:.3e})", flush=True)
        if not err <= limit:
            raise AssertionError(f"{label}: live affinities disagree with the plain version")
        return err
    n = min(out.shape[-1], 6)
    d = (out - ref).abs()
    bad = (d[..., [0, 1, 3]] > KERNEL_TOL).any(-1)  # thresh, mmax, frac
    bad |= d[..., 2] > Z_RTOL * ref[..., 2].abs()
    bad |= (out[..., 4:n] != ref[..., 4:n]).any(-1)  # n_above, cnt_at
    n_bad, rows = int(bad.sum()), bad.numel()
    far = int((bad & ~near_fn().to(bad.device)).sum()) if n_bad else 0
    err = d.max().item()
    print(f"{label}: max |kernel - plain| = {err:.3e}; {n_bad} of {rows} rows differ beyond "
          f"counts equal, z within {Z_RTOL} relative, the rest within {KERNEL_TOL} "
          f"({n_bad - far} near-tie rows, {far} others)", flush=True)
    if far or n_bad > NEAR_TIE_SHARE * rows or out[..., n:].any().item():
        raise AssertionError(f"{label}: kernel disagrees with plain version")
    return err


def run_passes(records):
    """K5 through the pass-breakdown tool, one compute mode at a time with
    the counts reset before and read after; then each cut against its plain
    version on the tool's inputs, timed and bounded."""
    import torch

    from fgvc_tpu_torch.bench import pass_breakdown as pb
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1
    from fgvc_tpu_torch.utils.profiler import events_ms

    reps = 20
    split = {}
    for mode in k1.COMPUTE_DTYPES:
        k1.reset_launches()
        res = pb.run("cuda", reps=reps, modes=(mode,))
        torch.cuda.synchronize()
        n = reps + 2  # warm-up, reps, one profiled call
        got = (dict(k1.cut_launches), k1.unbanked_launches, dict(k1.mode_launches))
        want = ({"a": n, "ab": n}, n, {m: n if m == mode else 0 for m in k1.mode_launches})
        print(f"passes '{mode}': cut launches {got[0]}, unbanked {got[1]}, by mode {got[2]} "
              f"(expected {n} each)", flush=True)
        if got != want:
            raise AssertionError(f"passes '{mode}': launches {got}, expected {want}")
        split[mode] = res["ms"][mode]
        for cut, kernels in res["device_ms_by_kernel"][mode].items():
            print(f"passes '{mode}' cut '{cut}' device ms by CUDA kernel (torch.profiler): "
                  + (_top(kernels) or "not measured"), flush=True)
        for cut in ("a", "ab"):
            by_kernel = res["device_ms_by_kernel"][mode][cut]
            ab = cut == "ab"  # cut 'a' runs no select_kernel
            records[f"K5_{cut}_{_TAG[mode]}"].update(
                launches=n, ms=split[mode][cut], affinity_device_ms=affinity_ms(by_kernel, 1),
                select_device_ms=affinity_ms(by_kernel, 1, "select_kernel") if ab else None,
                select_bound_ms=select_bound(H, W, CV, values=False) if ab else None)
    print("per-pass split (ms per call; A = t('a'), B = t('ab') - t('a'), C = t('abc') - t('ab')): "
          + json.dumps(split), flush=True)

    inputs = pb.make_inputs(device="cuda")
    q, k, v = inputs
    h, w = q.shape[:2]
    # query and keys (float32 at the entry in every mode), the cut's output
    nbytes = 4.0 * (h * w * C + SLOTS * h * w * C) + 4.0 * h * w * CV
    for mode in k1.COMPUTE_DTYPES:
        bound_ms, bound_by, flops = attention_bound(h, w, "circle", [True] * SLOTS, nbytes, mode)
        for cut in ("a", "ab"):
            record = records[f"K5_{cut}_{_TAG[mode]}"]
            label = f"K5 cut '{cut}' '{mode}'"
            kw = dict(radius=pb.RADIUS, temperature=pb.TEMPERATURE, topk=pb.TOPK, tile=pb.TILE,
                      compute_dtype=mode, debug_passes=cut)
            out = pb.call(inputs, mode, cut)
            ref = k1.topk_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            near_kw = {x: y for x, y in kw.items() if x != "debug_passes"}
            err = check_cut(label, out, ref, cut,
                            lambda: k1.near_tie_rows_plain_unbanked(q, k, v, stats=True,
                                                                    **near_kw))
            del out, ref
            plain_ms = events_ms(lambda: k1.topk_attention_plain(q, k, v, **kw), 3)
            print(f"{label}: kernel {record['ms']:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP live)", flush=True)
            record.update(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        # cut 'a' at every column of slot 0's window, live ones included
        full = torch.zeros((v.shape[0], h, w, FULL_WINDOW_CV), device=v.device)
        kw = dict(radius=pb.RADIUS, temperature=pb.TEMPERATURE, topk=pb.TOPK, tile=pb.TILE,
                  compute_dtype=mode, debug_passes="a")
        err = check_cut(f"K5 cut 'a' '{mode}' Cv={FULL_WINDOW_CV}",
                        k1.topk_attention(q, k, full, **kw),
                        k1.topk_attention_plain(q, k, full, **kw), "a", None)
        record = records[f"K5_a_{_TAG[mode]}"]
        record["max_abs_err"] = max(record["max_abs_err"], err)
        del full
    del inputs, q, k, v
    torch.cuda.empty_cache()


def overlap_bound(kind):
    """Least time for one K6 call: the products (three TF32 products each,
    on the tensor cores) and the rounds (4 SIMT operations an element) run
    side by side, so the larger of the two, or the bytes (q, k, out and the
    scratch writes) over the HBM rate."""
    from fgvc_tpu_torch.ops.cuda import mxu_vpu_overlap as k6

    t_mma = 3 * 2.0 * k6.S * k6.C * k6.T * k6.FK / PEAK_TF32_FLOPS if kind != "vpu" else 0.0
    cols, rounds = {"mxu": (0, 0), "vpu": (k6.T * k6.FK, k6.R), "mixed": (k6.FK, 2 * k6.T)}[kind]
    t_simt = 4.0 * k6.S * cols * rounds / PEAK_SIMT_OPS
    written = k6.FK if kind == "vpu" else k6.T * k6.FK
    nbytes = 4.0 * (k6.S * k6.C + k6.S * 128 + k6.S * written
                    + (0 if kind == "vpu" else k6.T * k6.FK * k6.C))
    t_ops, t_bytes = max(t_mma, t_simt), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def run_overlap(records):
    """K6 through the overlap tool with the counts reset before and read
    after; then each kind against its plain version, timed and bounded."""
    import torch

    from fgvc_tpu_torch.bench import mxu_vpu_overlap as bench
    from fgvc_tpu_torch.ops.cuda import mxu_vpu_overlap as k6
    from fgvc_tpu_torch.utils.profiler import events_ms

    k6.reset_launches()
    res = bench.run("cuda")
    torch.cuda.synchronize()
    n = res["iters"] + 1  # warm-up and the timed launches
    got = dict(k6.launches)
    print(f"overlap: launches {got} (expected {n} each)", flush=True)
    if got != dict.fromkeys(k6.KINDS, n):
        raise AssertionError(f"overlap: launches {got}, expected {n} each")
    q, k = bench.make_inputs("cuda")
    out = {kind: k6.overlap(kind, q, k) for kind in k6.KINDS}
    ref = {kind: k6.overlap_plain(kind, q, k) for kind in k6.KINDS}
    torch.cuda.synchronize()
    errs = {kind: (out[kind] - ref[kind]).abs().max().item() for kind in k6.KINDS}
    counts = [torch.round(r["mixed"] - r["mxu"]) for r in (out, ref)]
    frac = ((out["mixed"] - out["mxu"]) - counts[0]).abs().max().item()
    print(f"overlap: max |kernel - plain| mxu {errs['mxu']:.3e} (tolerance {MXU_TOL}), "
          f"mixed {errs['mixed']:.3e}, vpu {errs['vpu']:.3e}; mixed - mxu counts "
          f"{counts[0].min().item():.0f}..{counts[0].max().item():.0f} (plain "
          f"{counts[1].min().item():.0f}..{counts[1].max().item():.0f}), off an integer by "
          f"{frac:.2e}; vpu rows {out['vpu'].min().item():.0f}..{out['vpu'].max().item():.0f} "
          f"(must be {10 * k6.FK})", flush=True)
    if not errs["mxu"] <= MXU_TOL or not frac <= 1e-3 or not torch.equal(counts[0], counts[1]):
        raise AssertionError("overlap: 'mxu' or 'mixed' disagrees with the plain version")
    if not torch.equal(out["vpu"], torch.full_like(out["vpu"], 10.0 * k6.FK)):
        raise AssertionError("overlap: 'vpu' is not 10 * FK on every row")
    for kind in k6.KINDS:
        plain_ms = events_ms(lambda: k6.overlap_plain(kind, q, k), 3)
        bound_ms, bound_by = overlap_bound(kind)
        print(f"overlap {kind}: kernel {res['ms'][kind]:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {1e3 * bound_ms:.2f} us ({bound_by})"
              + (f", torch.matmul {res['matmul_ms']:.4f} ms" if kind == "mxu" else ""),
              flush=True)
        records[f"K6_{kind}"].update(
            launches=n, ms=res["ms"][kind], plain_ms=plain_ms, max_abs_err=errs[kind],
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=res["matmul_ms"] if kind == "mxu" else None)


def run_profile(data_root):
    """The port's CLI with --profile on one e2e pickle: the Chrome trace
    holds the harness's spans and both CUDA kernels of K1."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as logdir:
        cmd = [sys.executable, "-m", "fgvc_tpu_torch.cli.test", "--task", "davis",
               "--data-root", data_root, "--max-videos", "1", "--output-dir",
               os.path.join(logdir, "eval"), "--profile", logdir]
        t0 = time.time()
        subprocess.run(cmd, cwd=ROOT, check=True, timeout=900, stdout=subprocess.DEVNULL)
        path = os.path.join(logdir, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        found = {want: any(want in name for name in names)
                 for want in ("propagate[0]", "collect[0]", "affinity_kernel", "select_kernel")}
        print(f"profile: cli.test --profile in {time.time() - t0:.1f} s; {path}: "
              f"{os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events; found {found}",
              flush=True)
        if not all(found.values()):
            raise AssertionError(f"profile: the trace lacks {[k for k, v in found.items() if not v]}")


TRAIN_STEPS = 8           # full-width steps of phase train (a)
TRAIN_PROFILED = 3        # steps under torch.profiler
TRAIN_LOSS_RTOL = 1e-4    # (b) card against CPU, 'highest'
TRAIN_GRAD_RTOL = 1e-3    # (b) relative L2 per gradient leaf
TRAIN_RESUME_TOL = 1e-4   # (c) largest parameter difference
SMALL_TRAIN = dict(crop_size=64, radius=4, batch_size=2, matmul_precision="highest")


def _train_model(cfg, steps, work_dir, **kw):
    """fgvc_tpu_torch.apis.train.train_model on structured data, as
    python -m fgvc_tpu_torch.cli.train --synthetic-mode structured runs it."""
    from fgvc_tpu_torch.apis.train import train_model
    from fgvc_tpu_torch.datasets.flyingthings_ytv import (StructuredSyntheticMixedDataset,
                                                          make_batches)

    ds = StructuredSyntheticMixedDataset(crop=cfg.crop_size, seed=cfg.seed)
    skip = kw.pop("skip", 0)
    return train_model(cfg, make_batches(ds, cfg.batch_size, steps, skip=skip), work_dir,
                       steps_per_epoch=16, max_steps=steps, device="cuda", **kw)


def _read_log(work_dir):
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_train_full_width(work_dir):
    """(a) The TrainConfig defaults (crop 256, batch 4, radius 24, 'high',
    all three branches) for TRAIN_STEPS steps through train_model: finite
    losses, the median step ms from step 3 on, peak device memory; then
    TRAIN_PROFILED more steps under torch.profiler: busy share, top kernels."""
    import torch

    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import step_generator
    from fgvc_tpu_torch.datasets.flyingthings_ytv import (StructuredSyntheticMixedDataset,
                                                          make_batches)

    cfg = TrainConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    trainer = _train_model(cfg, TRAIN_STEPS, work_dir, log_interval=1,
                           ckpt_interval=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    logs = [r for r in _read_log(work_dir) if "loss" in r]
    if len(logs) != TRAIN_STEPS:
        raise AssertionError(f"train (a): {len(logs)} logged steps, expected {TRAIN_STEPS}")
    for r in logs:
        bad = [k for k in ("l1_loss", "sup_loss", "corr_da_loss", "loss") if not np.isfinite(r[k])]
        if bad:
            raise AssertionError(f"train (a): non-finite {bad} at step {r['step']}")
    step_ms = [1e3 / r["steps_per_sec"] for r in logs[2:]]
    print(f"train (a) full width (crop {cfg.crop_size}, batch {cfg.batch_size}, radius "
          f"{cfg.radius}, '{cfg.matmul_precision}', ResNet-18-d1): {TRAIN_STEPS} steps in "
          f"{wall:.1f} s (first steps include cuDNN's search); step ms from step 3 "
          f"{[round(x, 1) for x in step_ms]}, median {float(np.median(step_ms)):.1f} ms; "
          f"peak device memory {peak:.2f} GB", flush=True)
    print("train (a) losses: " + json.dumps({k: logs[-1][k] for k in
                                             ("l1_loss", "sup_loss", "corr_da_loss", "loss")}))
    ds = StructuredSyntheticMixedDataset(crop=cfg.crop_size, seed=cfg.seed + 1)
    batches = [trainer.to_device(b) for b in
               make_batches(ds, cfg.batch_size, TRAIN_PROFILED)]

    def steps():
        for b in batches:
            trainer.train_step(b, step_generator(cfg.seed, trainer.step))

    by_kernel, wall_ms = device_ms_by_kernel(steps)
    busy = sum(by_kernel.values())
    if busy:
        print(f"train (a) {TRAIN_PROFILED} profiled steps (batches on the card): wall "
              f"{wall_ms:.1f} ms ({wall_ms / TRAIN_PROFILED:.1f} per step), device busy "
              f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%); top kernels: "
              + _top(by_kernel, 8), flush=True)
    else:
        print("train (a) profile: device time not measured by torch.profiler")
    del trainer, batches
    torch.cuda.empty_cache()
    return float(np.median(step_ms)), peak


def _leaf_errors(a, b):
    """{name: relative L2 of a's gradient against b's} over a's modules."""
    out = {}
    for name, module in a.trainable().items():
        other = dict(b.trainable()[name].named_parameters())
        for pname, p in module.named_parameters():
            q = other[pname]
            if p.grad is None and q.grad is None:
                continue
            ref = q.grad.double().cpu()
            out[f"{name}.{pname}"] = float((p.grad.double().cpu() - ref).norm()
                                           / ref.norm().clamp_min(1e-30))
    return out


def run_train_card_vs_cpu():
    """(b) One loss_fn + backward at crop 64, radius 4, 'highest' on the card
    and on the CPU from the same weights, batch and dropped channels; each
    also against the CPU in float64 (printed: BN-bias gradients are sums
    that cancel, and float32 keeps a few 1e-3 of them)."""
    import torch

    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import MixedTrainer
    from fgvc_tpu_torch.datasets.flyingthings_ytv import (StructuredSyntheticMixedDataset,
                                                          make_batches)

    cfg = TrainConfig(**SMALL_TRAIN)
    cpu = MixedTrainer(cfg, device="cpu").init(0, 16)
    card = MixedTrainer(cfg, device="cuda")
    card.load_module_states({k: m.state_dict() for k, m in
                             {**cpu.trainable(), "teacher": cpu.teacher}.items()})
    card.reset_optimizer(16)
    batch = next(make_batches(StructuredSyntheticMixedDataset(crop=cfg.crop_size, seed=5),
                              cfg.batch_size, 1))
    # float64 on the CPU: how far float32 itself is from the gradients
    exact = MixedTrainer(cfg, device="cpu")
    exact.load_module_states({k: m.state_dict() for k, m in
                              {**cpu.trainable(), "teacher": cpu.teacher}.items()})
    for m in (*exact.trainable().values(), exact.teacher):
        m.double()
    losses = {}
    for name, trainer in (("cpu", cpu), ("card", card), ("float64", exact)):
        b = {k: torch.as_tensor(v).to(trainer.device, next(trainer.backbone.parameters()).dtype)
             for k, v in batch.items()}
        total, parts = trainer.loss_fn(b, (1, 2))
        total.backward()
        losses[name] = {k: float(v.detach()) for k, v in parts.items()}
    errs = _leaf_errors(card, cpu)
    worst = max(errs, key=errs.get)
    loss_err = max(abs(losses["card"][k] - v) / abs(v) for k, v in losses["cpu"].items())
    to_f64 = {name: max(_leaf_errors(t, exact).values()) for name, t in (("card", card),
                                                                          ("cpu", cpu))}
    print(f"train (b) card vs CPU (crop 64, radius 4, 'highest'): losses {losses['card']}, "
          f"largest relative loss difference {loss_err:.2e}; {len(errs)} gradient leaves, "
          f"worst {worst} at {errs[worst]:.2e} relative L2 (worst leaf against float64: "
          f"card {to_f64['card']:.2e}, CPU {to_f64['cpu']:.2e})", flush=True)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train (b): losses differ by {loss_err} relative")
    if not errs[worst] <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"train (b): gradient {worst} differs by {errs[worst]}")


def run_train_resume(root):
    """(c) 2 steps, a checkpoint, 2 resumed steps against 4 straight steps on
    the card (crop 64, radius 4): the largest parameter difference."""
    import torch

    from fgvc_tpu_torch.config import TrainConfig

    cfg = TrainConfig(**SMALL_TRAIN)
    a = _train_model(cfg, 4, os.path.join(root, "a"), ckpt_interval=100, resume=False)
    _train_model(cfg, 2, os.path.join(root, "b"), ckpt_interval=2, resume=False)
    b = _train_model(cfg, 4, os.path.join(root, "b"), ckpt_interval=100, resume=True, skip=2)
    diff = 0.0
    for name, module in a.trainable().items():
        for (k, v), w in zip(module.state_dict().items(),
                             b.trainable()[name].state_dict().values()):
            if v.is_floating_point():
                diff = max(diff, float((v - w).abs().max()))
    print(f"train (c) 2 + resume + 2 against 4 steps on the card: steps {a.step}, {b.step}; "
          f"largest parameter/statistic difference {diff:.3e}", flush=True)
    if a.step != 4 or b.step != 4 or not diff <= TRAIN_RESUME_TOL:
        raise AssertionError(f"train (c): resumed run differs by {diff}")
    torch.cuda.empty_cache()
    return b


def run_train_val(trainer, root):
    """(d) make_synthetic_val_fn on the student: mid-training validation
    through the port's Tracker launches K1 on the card."""
    from fgvc_tpu_torch.apis.train import make_synthetic_val_fn
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    val_fn = make_synthetic_val_fn(root, device="cuda")
    k1.reset_launches()
    metrics = val_fn(trainer)
    launches = (k1.launches, k1.unbanked_launches, k1.row_block_launches)
    print(f"train (d) mid-training validation: K1 launches {launches[0]} (K2 {launches[1]}, "
          f"K4 {launches[2]}); " + json.dumps({k: metrics[k] for k in
                                               ("average_pts_within_thresh", "average_jaccard")}),
          flush=True)
    check_metrics(metrics)
    if not launches[0] > 0:
        raise AssertionError("train (d): the validation launched no K1")


def run_train():
    """Phase train: (a) full width, (b) card against CPU, (c) resume, (d)
    mid-training validation through K1."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        t0 = time.time()
        run_train_full_width(os.path.join(root, "full"))
        run_train_card_vs_cpu()
        trainer = run_train_resume(root)
        run_train_val(trainer, root)
        print(f"train phase {time.time() - t0:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="card,build,kernel,e2e,plain,vos,vos_plain,modes,sp,"
                                        "passes,overlap,profile,train")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import fgvc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the fgvc_tpu_torch package is not beside this file ({e})",
              file=sys.stderr)
        return 1

    pallas = "fgvc_tpu/ops/pallas/topk_attention.py"
    records = {
        # _call_fused_kernel, through fused_topk_attention_banked (K1) and
        # fused_topk_attention (K2), in 'float32' mode
        "K1_circle": kernel_record("K1 topk_attention_banked, circle", f"{pallas}:597"),
        "K1_square": kernel_record("K1 topk_attention_banked, square", f"{pallas}:597"),
        "K2": kernel_record("K2 topk_attention (unbanked), square", f"{pallas}:424"),
    }
    # K3: the same kernel in mode 'high' (bf16x3, from :192) and 'bfloat16'
    # (from :201), through both entries
    for mode, tag, line in (("high", "high", 192), ("bfloat16", "bf16", 201)):
        for entry, name in (("circle", "topk_attention_banked, circle"),
                            ("square", "topk_attention_banked, square"),
                            ("unbanked", "topk_attention (unbanked), square")):
            records[f"K3_{tag}_{entry}"] = kernel_record(f"K3 '{mode}' {name}",
                                                         f"{pallas}:{line}")
    # K4: the same kernel's row-block mode (row0, from :110; grid_rows)
    for shape in ("circle", "square"):
        records[f"K4_{shape}"] = kernel_record(
            f"K4 topk_attention_banked row blocks, {shape}", f"{pallas}:110")
    # K5: the unbanked entry's profiling cut-downs ('a' from :229, 'ab' from
    # :324), in each mode
    for mode, tag in _TAG.items():
        for cut, line in (("a", 229), ("ab", 324)):
            records[f"K5_{cut}_{tag}"] = kernel_record(
                f"K5 topk_attention debug_passes='{cut}', '{mode}'", f"{pallas}:{line}")
    # K6: the overlap microbenchmark (make :31 -> pallas_call :92)
    for kind in ("mxu", "vpu", "mixed"):
        records[f"K6_{kind}"] = kernel_record(
            f"K6 mxu_vpu_overlap '{kind}'", "tools/bench/mxu_vpu_overlap.py:31",
            source="fgvc_tpu_torch/csrc/mxu_vpu_overlap.cu", affinity=False)
    t_start = time.time()
    phase("card")
    print(card_info(), flush=True)  # name, power limit
    if "build" in phases:
        phase("build")
        build_kernels()
    if "kernel" in phases:
        phase("kernel")
        check_kernels(records)
        check_tie_heavy()
        check_row_blocks(records)
    e2e_metrics = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as data_root:
        if {"e2e", "plain", "modes", "sp", "profile"} & set(phases):
            make_tapvid_pickles(data_root)
        if "e2e" in phases:
            phase("e2e")
            e2e_metrics = run_e2e(data_root, records["K1_circle"])
        if "plain" in phases:
            phase("plain")
            run_plain_comparison(data_root)
        if "vos" in phases or "vos_plain" in phases:
            ds = SyntheticDavis()
            if "vos" in phases:
                phase("vos")
                run_vos(ds, records)
            if "vos_plain" in phases:
                phase("vos_plain")
                run_vos_plain(ds)
            del ds
        if "modes" in phases:
            phase("modes")
            run_modes_tapvid(data_root, records)
            run_modes_vos(records)
        if "sp" in phases:
            phase("sp")
            card = torch.device("cuda", torch.cuda.current_device())
            run_sp_tapvid(data_root, records["K4_circle"], card, e2e_metrics)
            run_sp_vos(records["K4_square"], card)
        if "passes" in phases:
            phase("passes")
            run_passes(records)
        if "overlap" in phases:
            phase("overlap")
            run_overlap(records)
        if "profile" in phases:
            phase("profile")
            run_profile(data_root)
    if "train" in phases:
        phase("train")
        run_train()
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
