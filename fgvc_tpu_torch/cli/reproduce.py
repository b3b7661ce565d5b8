#!/usr/bin/env python
"""One-command reproduction of the reference's published benchmarks on the
port (fgvc_tpu/cli/reproduce.py):

    python -m fgvc_tpu_torch.cli.reproduce \
        --checkpoint res18_d1_fly_ytv_mixed_training.pth \
        --davis-root /data/tapvid_davis \
        --kinetics-root /data/tapvid_kinetics \
        --jhmdb-root /data/jhmdb --jhmdb-list /data/jhmdb \
        --badja-root /data/badja [--fast-modes] [--device cpu]

Steps (a task is skipped when its root is not given):
  1. feature parity probe: the SAME released ``.pth`` loaded into a plain
     torch ResNet-18-d1 twin (the reference encoder, eval-mode BN) and into
     the port's model (models/weights.py, strict); layer3 features of
     seeded random frames must agree within 1e-3, with TF32 off in
     convolutions and matrix products.  Exit 2 on failure unless --force;
  2. benchmark runs: every task through apis/test.run_task at the
     reference's settings (TASK_CONFIGS), compared with the published
     number within the 0.5-point parity bar;
  3. --fast-modes: TAP-Vid-DAVIS again with the top-k attention kernel in
     bfloat16 ('bf16_matmuls'), in bfloat16 with I420 upload
     ('pallas_bf16_yuv') and with coarse decoding ('coarse_decode'), each
     reported as its delta against the exact run.

Writes report.json and report.md under --output-dir and prints the table;
exits 1 when a task misses the bar.  Runs on the CUDA card unless --device
cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

# task -> (headline metric key, published reference value)
EXPECTED = {
    "davis": ("average_pts_within_thresh", 62.8),
    "kinetics": ("average_pts_within_thresh", 54.6),
    "jhmdb": ("PCK@0.1", 66.8),
    "badja": ("PCK@0.2", 69.7),
}
PARITY_BAR = 0.5  # points
PROBE_TOL = 1e-3
FAST_MODES = {
    "bf16_matmuls": dict(matmul_precision="default"),
    "pallas_bf16_yuv": dict(matmul_precision="default", upload_format="yuv420"),
    "coarse_decode": dict(decode_impl="coarse"),
}


class _TwinBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                            nn.BatchNorm2d(planes))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(out)) + idt)


class TorchTwin(nn.Module):
    """The reference encoder in plain torch.nn, independent of the port's
    model: ResNet-18 with strides (1, 1, 1, 4), no stem pool, layer3 out."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        inplanes = 64
        for i, s in enumerate((1, 1, 1, 4)):
            planes = 64 * 2**i
            setattr(self, f"layer{i + 1}",
                    nn.Sequential(_TwinBlock(inplanes, planes, s), _TwinBlock(planes, planes)))
            inplanes = planes

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        for i in range(3):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


def from_mmcv_naming(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """mmcv ConvModule checkpoint keys ('conv1.conv.weight',
    'layer1.0.conv1.bn.*', 'downsample.conv/bn') -> TorchTwin's keys."""
    rules = [
        (r"^conv1\.conv\.weight$", "conv1.weight"),
        (r"^conv1\.bn\.", "bn1."),
        (r"(layer\d+\.\d+)\.conv(\d)\.conv\.weight$", r"\1.conv\2.weight"),
        (r"(layer\d+\.\d+)\.conv(\d)\.bn\.", r"\1.bn\2."),
        (r"(layer\d+\.\d+)\.downsample\.conv\.weight$", r"\1.downsample.0.weight"),
        (r"(layer\d+\.\d+)\.downsample\.bn\.", r"\1.downsample.1."),
    ]
    out = {}
    for k, v in state.items():
        for pattern, repl in rules:
            k = re.sub(pattern, repl, k)
        out[k] = v
    return out


def parity_probe(checkpoint: str, frames: int = 2, size: int = 256,
                 device: Optional[str] = None) -> dict:
    """Step 1: TorchTwin's and the port's layer3 features from the same
    ``.pth`` on `device` (the card unless named), with TF32 off.  Returns
    {'max_abs', 'ok' (max_abs < 1e-3), 'unexpected_keys' (keys of the
    backbone the twin does not know)}."""
    from fgvc_tpu_torch.device import resolve_device, set_matmul_precision
    from fgvc_tpu_torch.models.resnet import resnet18_d1
    from fgvc_tpu_torch.models.weights import load_reference_pth, load_weights, read_pth

    dev = resolve_device(device)
    raw = read_pth(checkpoint)
    prefix = "backbone."
    state = {k[len(prefix):]: v for k, v in raw.items() if k.startswith(prefix)}
    if not state:  # a backbone-only checkpoint
        state, prefix = raw, ""
    twin = TorchTwin()
    missing, unexpected = twin.load_state_dict(from_mmcv_naming(state), strict=False)
    missing = [k for k in missing if "num_batches_tracked" not in k]
    if missing:
        raise KeyError(f"torch twin missing weights: {missing[:8]}")
    model = load_weights(resnet18_d1(), load_reference_pth(checkpoint, prefix=prefix))
    twin, model = twin.to(dev).eval(), model.to(dev).eval()

    x = np.random.default_rng(0).standard_normal((frames, size, size, 3)).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))).to(dev)
    set_matmul_precision("highest")  # TF32 off in matmuls and cuDNN convolutions
    with torch.no_grad():
        ours, ref = model(x), twin(x)
    max_abs = float((ours - ref).abs().max().cpu())
    return {"max_abs": max_abs, "ok": max_abs < PROBE_TOL, "unexpected_keys": len(unexpected)}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="reproduce the reference benchmarks on the port")
    p.add_argument("--checkpoint", required=True,
                   help="released .pth, or a port training checkpoint (step_N directory "
                        "or latest/best pointer)")
    p.add_argument("--davis-root", default=None)
    p.add_argument("--kinetics-root", default=None)
    p.add_argument("--jhmdb-root", default=None)
    p.add_argument("--jhmdb-list", default=None)
    p.add_argument("--badja-root", default=None)
    p.add_argument("--output-dir", default="reproduce_results")
    p.add_argument("--max-videos", type=int, default=None,
                   help="cap videos per task (smoke runs; full runs omit this)")
    p.add_argument("--skip-parity", action="store_true")
    p.add_argument("--force", action="store_true",
                   help="run the tasks even if the feature-parity probe fails")
    p.add_argument("--fast-modes", action="store_true",
                   help="also run DAVIS in the speed modes and report their deltas")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    from fgvc_tpu_torch.apis import test as harness
    from fgvc_tpu_torch.device import resolve_device

    device = str(resolve_device(args.device))
    os.makedirs(args.output_dir, exist_ok=True)
    report = {"checkpoint": args.checkpoint, "tasks": {}, "max_videos": args.max_videos}

    if not args.skip_parity and args.checkpoint.endswith(".pth"):
        probe = parity_probe(args.checkpoint, device=device)
        report["feature_parity"] = probe
        print(f"[parity] layer3 max|Δ| = {probe['max_abs']:.2e} -> "
              f"{'OK' if probe['ok'] else 'FAILED'}")
        if not probe["ok"]:
            print("[parity] conversion mismatch — fix before trusting any benchmark "
                  "number below")
            if not args.force:
                print("[parity] aborting (pass --force to evaluate anyway)")
                sys.exit(2)

    roots = {
        "davis": (args.davis_root, None),
        "kinetics": (args.kinetics_root, None),
        "jhmdb": (args.jhmdb_root, args.jhmdb_list),
        "badja": (args.badja_root, None),
    }
    rows = []
    for task, (root, list_path) in roots.items():
        if not root:
            continue
        key, expected = EXPECTED[task]
        print(f"[{task}] running on {root} ...")
        res = harness.run_task(task, root, checkpoint=args.checkpoint, list_path=list_path,
                               max_videos=args.max_videos,
                               output_dir=os.path.join(args.output_dir, task), device=device)
        value = float(res[key])
        delta = value - expected
        within = abs(delta) <= PARITY_BAR
        report["tasks"][task] = {"metric": key, "value": value, "expected": expected,
                                 "delta": delta, "within_bar": within, "all_metrics": res}
        rows.append((task, key, value, expected, delta, within))
        print(f"[{task}] {key} = {value:.2f} (ref {expected}, Δ {delta:+.2f}, "
              f"{'PASS' if within else 'CHECK'} @ ±{PARITY_BAR})")

    if args.fast_modes and args.davis_root:
        base = report["tasks"].get("davis")
        report["fast_modes"] = {}
        for name, overrides in FAST_MODES.items():
            cfg = dataclasses.replace(harness.TASK_CONFIGS["davis"], **overrides)
            res = harness.run_task("davis", args.davis_root, checkpoint=args.checkpoint,
                                   max_videos=args.max_videos, test_cfg=cfg, device=device)
            v = float(res["average_pts_within_thresh"])
            d = v - base["value"] if base else float("nan")
            report["fast_modes"][name] = {"value": v, "delta_vs_exact": d}
            print(f"[fast:{name}] <D = {v:.2f} (Δ vs exact {d:+.2f})")

    md = ["| task | metric | ours | reference | Δ | within ±0.5 |",
          "|---|---|---|---|---|---|"]
    for task, key, value, expected, delta, within in rows:
        md.append(f"| {task} | {key} | {value:.2f} | {expected} "
                  f"| {delta:+.2f} | {'yes' if within else 'NO'} |")
    md_text = "\n".join(md)
    print(md_text)
    with open(os.path.join(args.output_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2, default=float)
    with open(os.path.join(args.output_dir, "report.md"), "w") as f:
        f.write(md_text + "\n")
    print(f"report written to {args.output_dir}/report.{{json,md}}")
    if any(not within for *_, within in rows):
        sys.exit(1)


if __name__ == "__main__":
    main()
