"""Tracing and profiling utilities of the port (fgvc_tpu/utils/profiler.py).

* PhaseTimer: named wall-clock phases; on a CUDA device each edge waits for
  the device (``torch.cuda.synchronize``), so per-phase times mean what they
  say.  JSONL export for dashboards.
* trace(logdir): ``torch.profiler`` over the CPU and the CUDA device, written
  as a Chrome trace (``trace.json``) into logdir; a no-op when logdir is
  falsy, so a --profile flag threads straight through.
* annotate(name): a named span inside the trace (``record_function``), and
  an NVTX range where CUDA is present.

Used by ``python -m fgvc_tpu_torch.cli.test --profile LOGDIR``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from collections import defaultdict
from typing import Dict, Optional, Union

import torch

TRACE_FILE = "trace.json"


class PhaseTimer:
    """Accumulates wall-clock per named phase with device-synced edges.

    >>> pt = PhaseTimer(device="cuda")
    >>> with pt.phase("features"):
    ...     feats = extract(video)
    >>> pt.summary()   # {'features': {'total_s': ..., 'calls': ...}}
    """

    def __init__(self, device: Optional[Union[str, torch.device]] = None, sync: bool = True):
        self.device = None if device is None else torch.device(device)
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    def _sync(self) -> None:
        if self.sync and self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "calls": self.calls[k],
                "mean_ms": round(1e3 * self.totals[k] / self.calls[k], 3),
            }
            for k in self.totals
        }

    def dump_jsonl(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(json.dumps({"ts": time.time(), "phases": self.summary()}) + "\n")

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1.0
        lines = ["phase                    total_s   calls   mean_ms   share"]
        for k, v in rows:
            lines.append(
                f"{k:<24} {v:7.3f} {self.calls[k]:7d} "
                f"{1e3 * v / self.calls[k]:9.2f} {100 * v / total:6.1f}%"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Device and host trace with torch.profiler (CPU and, where present,
    CUDA activities), written to logdir/trace.json (chrome://tracing,
    Perfetto).  No-op when logdir is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named span inside the trace: torch.profiler's record_function, and
    an NVTX range where CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_ms_by_kernel(fn):
    """Run fn under torch.profiler (CPU and CUDA activities); {CUDA kernel
    name: device ms} and the wall ms of the run (an empty dict where the
    profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    out: Dict[str, float] = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            out[evt.key] = out.get(evt.key, 0.0) + us / 1e3
    return out, wall_ms


def events_ms(fn, reps: int, back_to_back: bool = False) -> float:
    """Device milliseconds of one fn() by CUDA events on the current stream
    (warm up first: a kernel's first call builds it): the median over `reps`
    calls timed one by one, or with `back_to_back` the mean of `reps` calls
    queued between one pair of events (the host's launch cost then hides
    behind the device's work when a call runs longer than it takes to
    launch)."""
    if back_to_back:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
