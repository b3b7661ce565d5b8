#!/usr/bin/env python
"""Environment doctor of the port (fgvc_tpu/cli/doctor.py): is this machine
ready to run fgvc_tpu_torch?

What can hang or fail on a machine with a card is probed in a bounded
subprocess, so the doctor itself always returns: the device answers a
first operation, a 256² matrix product is exact, a 1 MiB round trip to the
device is timed, and on CUDA the kernels are built with nvcc and the top-k
attention kernel (K1) is launched on a small input and held to its plain
version (1e-4 a query pixel, near-tie rows excepted).  Then: nvcc, the
kernel build directory (built or cold), the optional imports, and the
environment (utils/env.collect_env).

    python -m fgvc_tpu_torch.cli.doctor [--device cuda|cpu] [--probe-timeout 300] [--json]

Exit code 0 when the device responds (and, on CUDA, K1 agrees with its
plain version), 1 when it does not.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]  # the directory that holds the package

# K1 in the probe: the main path's settings on a 32 x 32 grid
PROBE_HW, PROBE_C, PROBE_CV, PROBE_SLOTS = 32, 256, 8, 6
PROBE_RADIUS, PROBE_TILE, PROBE_TOPK, PROBE_TEMPERATURE = 15.0, 16, 10, 0.07
KERNEL_TOL = 1e-4

OPTIONAL_IMPORTS = {
    "PIL": "decodes the DAVIS, JHMDB and BADJA frames and TAP-Vid JPEG bytes",
    "cv2": "optional: the readers reproduce cv2's resize in numpy",
    "tensorboardX": "optional: training's TensorBoard log",
}


def check_k1(dev) -> dict:
    """K1 (banked, circle) against its plain version on seeded inputs."""
    import numpy as np
    import torch

    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    rng = np.random.default_rng(0)
    hw, T = PROBE_HW, PROBE_SLOTS
    feats = torch.from_numpy(rng.standard_normal((T + 1, hw, hw, PROBE_C), dtype=np.float32))
    value = torch.from_numpy(rng.random((T, hw, hw, PROBE_CV), dtype=np.float32))
    kpad = k1.pad_key_bank(feats.to(dev), PROBE_RADIUS, tile=PROBE_TILE)
    halo, hp, wp, _, _ = k1.bank_geometry(hw, hw, PROBE_RADIUS, PROBE_TILE)
    kw = dict(qpad=kpad[T, halo:halo + hp, halo:halo + wp].contiguous(), kpad=kpad,
              value=value.to(dev), frame_idx=list(range(T)), key_valid=[True] * T, H=hw,
              W=hw, radius=PROBE_RADIUS, temperature=PROBE_TEMPERATURE, topk=PROBE_TOPK,
              tile=PROBE_TILE, mask_shape="circle")
    out = k1.topk_attention_banked(**kw)
    ref = k1.topk_attention_banked_plain(**kw)
    beyond = (out - ref).abs().amax(-1) > KERNEL_TOL
    others = int((beyond & ~k1.near_tie_rows_plain(**kw)).sum()) if beyond.any() else 0
    err = float((out - ref).abs().max())
    return {"ok": others == 0 and err == err, "max_abs_err": err,
            "rows_beyond": int(beyond.sum()), "rows_beyond_not_near_tie": others}


def probe(device: str) -> dict:
    """The device's answers (run in the doctor's subprocess)."""
    import torch

    from fgvc_tpu_torch.device import resolve_device
    from fgvc_tpu_torch.utils.env import card_info

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    dev = resolve_device(device)
    x = torch.ones((256, 256), device=dev)
    s = float((x @ x).sum())
    t1 = time.perf_counter()
    host = torch.ones((1 << 20,), dtype=torch.uint8)  # 1 MiB host -> device -> host
    sync()
    t2 = time.perf_counter()
    host.to(dev).to("cpu")
    sync()
    t3 = time.perf_counter()
    report = {
        "device": str(dev),
        "name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card_info() if dev.type == "cuda" else None,
        "first_op_s": round(t1 - t0, 3),
        "transfer_MBps": round(2 / max(t3 - t2, 1e-9), 1),
        "matmul_ok": s == 256.0 * 256 * 256,
    }
    if dev.type == "cuda":
        from fgvc_tpu_torch.ops.cuda.build import CSRC_DIR, build_all

        t4 = time.perf_counter()
        build_all(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))
        report["build_s"] = round(time.perf_counter() - t4, 1)
        report["k1"] = check_k1(dev)
    return report


def _probe_check(probe_timeout: float, device: str) -> dict:
    code = ("import json, sys; from fgvc_tpu_torch.cli.doctor import probe; "
            f"print(json.dumps(probe({device!r})))")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(CHECKOUT), env.get("PYTHONPATH")]))
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=probe_timeout, cwd=CHECKOUT, env=env)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"no response in {probe_timeout:.0f}s",
                "waited_s": round(time.perf_counter() - t0, 1)}
    if out.returncode != 0:
        return {"ok": False, "error": out.stderr.strip()[-500:]}
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    ok = rep["matmul_ok"] and rep.get("k1", {"ok": True})["ok"]
    return {"ok": ok, **rep}


def _nvcc_check() -> dict:
    from fgvc_tpu_torch.ops.cuda.build import _nvcc

    try:
        nvcc = _nvcc()
    except RuntimeError as e:
        return {"ok": False, "error": str(e)}
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    return {"ok": out.returncode == 0, "path": nvcc,
            "version": (out.stdout.strip().splitlines() or [""])[-1]}


def _build_dir_check() -> dict:
    from fgvc_tpu_torch.ops.cuda.build import BUILD_DIR, CSRC_DIR, library_path

    sources = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    built = [name for name in sources if library_path(name).exists()]
    return {"ok": True, "dir": str(BUILD_DIR), "built": built,
            "note": "warm" if built == sources else "cold (the first run builds with nvcc)"}


def run_checks(probe_timeout: float = 300.0, device: str = "cuda") -> dict:
    report: dict = {"checks": {"device": _probe_check(probe_timeout, device)}}
    checks = report["checks"]
    if checks["device"]["ok"]:
        from fgvc_tpu_torch.utils.env import collect_env

        report["env"] = collect_env()
    checks["nvcc"] = _nvcc_check()
    checks["kernel_build"] = _build_dir_check()
    for mod, need in OPTIONAL_IMPORTS.items():
        try:
            __import__(mod)
            checks[mod] = {"ok": True}
        except ImportError:
            checks[mod] = {"ok": False, "note": need}
    report["ok"] = checks["device"]["ok"]
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description="fgvc_tpu_torch environment doctor")
    p.add_argument("--probe-timeout", type=float, default=300.0,
                   help="seconds the device probe may take (on CUDA it builds the kernels)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device to probe")
    p.add_argument("--json", action="store_true", help="machine-readable")
    args = p.parse_args(argv)

    report = run_checks(args.probe_timeout, device=args.device)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for name, chk in report["checks"].items():
            mark = "ok " if chk.get("ok") else "FAIL"
            print(f"[{mark}] {name}: { {k: v for k, v in chk.items() if k != 'ok'} }")
        for k, v in report.get("env", {}).items():
            print(f"      {k}: {v}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
