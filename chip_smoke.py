#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fgvc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--phases card,build,kernel,e2e,plain]

Phases, each of which raises on failure (exit code != 0):
  card    the card's name and power limit (nvidia-smi);
  build   every CUDA source of fgvc_tpu_torch/csrc, one nvcc each, in parallel;
  kernel  K1 (top-k attention) against its plain PyTorch version on the card
          at DAVIS shapes (128 x 128 x 256 features, 6 key slots, radius 15,
          top-10, 32 values): distinct key frames, and the first step's tie
          case (frame 0 in two valid slots).  max |diff| <= 1e-4: outputs are
          convex mixes of values in [0, 1] and the sums run in another order;
  e2e     run_task('davis') (the CLI's path) on two synthetic TAP-Vid pickles
          (48 frames, 256 x 256, 32 tracks) with seeded random weights at the
          full width of ResNet-18-d1; K1's launches must equal the frames
          propagated;
  plain   one of those videos again with the propagation forced through the
          plain version on the card: median trajectory |diff| <= 1e-3 px and
          <D within 0.1.
The line before the last is a JSON object with each kernel's numbers; the last
line is {"ok": true, "device": {...}}.  Without a CUDA card, or without the
fgvc_tpu_torch package beside this file, it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth; they assume the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KERNEL_TOL = 1e-4
TRAJ_TOL_PX = 1e-3
DELTA_D_TOL = 0.1

# DAVIS main-path shapes (DAVIS_TEST_CFG, ResNet-18-d1 at 256 x 256)
H = W = 128
C = 256
SLOTS = 6
RADIUS = 15.0
TOPK = 10
TILE = 16
TEMPERATURE = 0.07
CV = 32


def phase(name):
    print(f"== {name}", flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def build_kernels():
    from fgvc_tpu_torch.ops.cuda.build import CSRC_DIR, build_all

    names = sorted(p[:-3] for p in os.listdir(CSRC_DIR) if p.endswith(".cu"))
    t0 = time.time()
    logs = build_all(names)
    dt = time.time() - t0
    for name, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"built {name}.cu: " + ("; ".join(usage) if usage else "cached"))
    print(f"build time {dt:.1f} s for {len(names)} source(s)", flush=True)


def _events_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms_by_kernel(fn):
    """Run fn under torch.profiler; {CUDA kernel name: device ms} and the
    wall ms of the run (empty dict where the profiler saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            out[evt.key] = out.get(evt.key, 0.0) + us / 1e3
    return out, wall_ms


def _top(ms_by_name, n=6):
    items = sorted(ms_by_name.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{name[:60]} {ms:.2f} ms" for name, ms in items)


def k1_bound(frame_idx, key_valid, Cv, rows_total, cols_total, Hp, Wp):
    """Least time for one K1 call on these inputs: the larger of the live
    affinity products (in-circle, in-image, valid-slot pairs, 2 * C flops
    each, over the fp32 peak) and the bytes (query, the distinct key frames
    of the padded bank, values, output; each once, over the HBM rate)."""
    r2 = RADIUS * RADIUS
    halo = int(RADIUS)
    pairs_per_slot = 0
    for dy in range(-halo, halo + 1):
        for dx in range(-halo, halo + 1):
            if dy * dy + dx * dx < r2:
                pairs_per_slot += (H - abs(dy)) * (W - abs(dx))
    flops = 2.0 * C * pairs_per_slot * sum(bool(v) for v in key_valid)
    frames = {int(i) for i, v in zip(frame_idx, key_valid) if v}
    nbytes = 4.0 * (Hp * Wp * C + len(frames) * rows_total * cols_total * C
                    + len(frame_idx) * H * W * Cv + H * W * Cv)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def check_kernel(record):
    import torch

    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((SLOTS + 1, H, W, C), dtype=np.float32)).cuda()
    kpad = k1.pad_key_bank(feats, RADIUS, tile=TILE)
    halo, Hp, Wp, rows_total, cols_total = k1.bank_geometry(H, W, RADIUS, TILE)
    value = rng.random((SLOTS, H, W, CV), dtype=np.float32)
    tie_value = value.copy()
    tie_value[-1] = tie_value[0]
    cases = {
        # distinct key frames 0..5, query frame 6
        "distinct": (list(range(SLOTS)), [True] * SLOTS, SLOTS, value),
        # step t = 1: frame 0 in slot 0 and slot 5, the rest before the video
        "t1_tie": ([0] * SLOTS, [True] + [False] * (SLOTS - 2) + [True], 1, tie_value),
    }
    errs = []
    for name, (fidx, valid, qf, val) in cases.items():
        qpad = kpad[qf, halo:halo + Hp, halo:halo + Wp].contiguous()
        v = torch.from_numpy(val).cuda()
        kw = dict(frame_idx=fidx, key_valid=valid, H=H, W=W, radius=RADIUS,
                  temperature=TEMPERATURE, topk=TOPK, tile=TILE)
        out = k1.topk_attention_banked(qpad, kpad, v, **kw)
        ref = k1.topk_attention_banked_plain(qpad, kpad, v, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"K1 {name}: non-finite output")
        err = (out - ref).abs().max().item()
        errs.append(err)
        print(f"K1 {name}: max |kernel - plain| = {err:.3e} (tolerance {KERNEL_TOL})")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"K1 {name}: kernel disagrees with plain version ({err})")
        if name == "distinct":
            ms = _events_ms(lambda: k1.topk_attention_banked(qpad, kpad, v, **kw), 20)
            plain_ms = _events_ms(lambda: k1.topk_attention_banked_plain(qpad, kpad, v, **kw), 3)
            bound_ms, bound_by, flops = k1_bound(fidx, valid, CV, rows_total, cols_total, Hp, Wp)
            win = TILE + 2 * halo
            dense = 2.0 * C * Hp * Wp * SLOTS * win * win  # the halo windows the kernel computes
            print(f"K1 distinct: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP live, "
                  f"{dense / 1e9:.2f} GFLOP in dense halo windows), "
                  f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of live work", flush=True)
            record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            reps = 5
            by_kernel, _ = device_ms_by_kernel(
                lambda: [k1.topk_attention_banked(qpad, kpad, v, **kw) for _ in range(reps)])
            print("K1 device ms per launch by CUDA kernel (torch.profiler): " + (
                _top({n: t / reps for n, t in by_kernel.items()}) or "not measured"))
    record["max_abs_err"] = max(errs)


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


def run_e2e(data_root, record):
    import torch

    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    expect = frames_propagated(ds)
    n_frames = sum(len(ds[i]["video"]) for i in range(len(ds)))

    k1.launches = 0
    t0 = time.time()
    metrics = run_task("davis", data_root, device="cuda", seed=0)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = k1.launches
    check_metrics(metrics)
    print("TAP-Vid metrics (random weights): " + json.dumps(
        {k: metrics[k] for k in ("average_pts_within_thresh", "average_jaccard",
                                 "occlusion_accuracy", "pts_within_1", "pts_within_4",
                                 "pts_within_16")}))
    print(f"e2e: {len(ds)} videos, {n_frames} frames in {dt:.2f} s = "
          f"{n_frames / dt:.2f} frames/s (model build and data reading included)")
    print(f"K1 launches on the main path: {launches} (frames propagated: {expect})", flush=True)
    if launches != expect:
        raise AssertionError(f"K1 launched {launches} times, expected {expect}")
    record["launches"] = launches


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="card,build,kernel,e2e,plain")
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

    record = {
        "name": "topk_attention",
        "route": "cuda",
        "source": "fgvc_tpu_torch/csrc/topk_attention.cu",
        "replaces": "fgvc_tpu/ops/pallas/topk_attention.py:597",
        "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
        "bound_ms": None, "bound_by": None,
        "library_ms": None,  # no single PyTorch call computes this function
    }
    t_start = time.time()
    phase("card")
    print(card_info(), flush=True)  # name, power limit
    if "build" in phases:
        phase("build")
        build_kernels()
    if "kernel" in phases:
        phase("kernel")
        check_kernel(record)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as data_root:
        if "e2e" in phases or "plain" in phases:
            make_tapvid_pickles(data_root)
        if "e2e" in phases:
            phase("e2e")
            run_e2e(data_root, record)
        if "plain" in phases:
            phase("plain")
            run_plain_comparison(data_root)
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
