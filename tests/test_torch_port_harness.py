"""The port's profiling path around the evals: utils/profiler.py (PhaseTimer,
trace, annotate), utils/env.py, the evals' one-video read-ahead and named
spans, and the CLI's --profile, on the CPU at a small size (the task's preset
cut to 32 x 32 inputs).  The profiling tool of K5 runs here on the plain
versions (`--device cpu --size 16`)."""

import dataclasses
import json
import logging
import os
import pickle
import threading

import numpy as np
import pytest
import torch

from fgvc_tpu_torch.utils import env
from fgvc_tpu_torch.utils.profiler import PhaseTimer, annotate, trace

H = W = 32
SMALL = dict(input_size=(H, W), neighbor_range=8, tile=8)
VOS = dict(precede_frames=3, topk=4, temperature=0.07, neighbor_range=10, input_size=(H, W),
           tile=8)


def test_phase_timer(tmp_path):
    pt = PhaseTimer(device="cpu")
    for _ in range(2):
        with pt.phase("features"):
            torch.ones(8).sum()
    with pt.phase("propagate"):
        pass
    summary = pt.summary()
    assert summary["features"]["calls"] == 2 and summary["propagate"]["calls"] == 1
    assert set(summary["features"]) == {"total_s", "calls", "mean_ms"}
    path = tmp_path / "phases.jsonl"
    pt.dump_jsonl(str(path))
    assert json.loads(path.read_text())["phases"] == summary
    report = pt.report().splitlines()
    assert report[0].split()[0] == "phase" and len(report) == 3


def test_trace_and_annotate(tmp_path):
    with trace(None):  # no-op: no profiler, no file
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []
    with annotate("outside"):  # a span without a profiler is harmless
        torch.ones(4).sum()
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        with annotate("propagate[7]"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(logdir / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "propagate[7]" in names


def test_collect_env_and_logger():
    info = env.collect_env()
    assert {"python", "platform", "torch", "cuda", "cuda_available", "devices"} <= set(info)
    assert info["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert env.card_info() is None and "card" not in info
    logger = env.get_root_logger()
    assert logger.name == "fgvc_tpu_torch" and logger.level == logging.INFO
    assert env.get_root_logger() is logger


def test_read_ahead_keeps_the_order():
    from fgvc_tpu_torch.apis.test import _read_ahead

    main = threading.get_ident()

    class Slow:
        threads = {}

        def __getitem__(self, i):
            self.threads[i] = threading.get_ident()
            return {"i": i}

    ds = Slow()
    ids = [3, 0, 2, 1]
    assert [s["i"] for s in _read_ahead(ds, ids)] == ids
    assert ds.threads[3] == main  # the first video is read in line
    assert all(ds.threads[i] != main for i in ids[1:])  # the rest ahead
    assert list(_read_ahead(ds, [])) == []


def _write_pickles(root, n=2, T=4, seed=8):
    rng = np.random.default_rng(seed)
    for v in range(n):
        rec = {"video": rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8),
               "points": rng.uniform(0.2, 0.8, (3, T, 2)).astype(np.float32),
               "occluded": np.zeros((3, T), bool)}
        with open(os.path.join(root, f"vid{v}.pkl"), "wb") as f:
            pickle.dump(rec, f)


@pytest.fixture
def small_davis(monkeypatch):
    from fgvc_tpu_torch.apis import test as api

    monkeypatch.setitem(api.TASK_CONFIGS, "davis",
                        dataclasses.replace(api.TASK_CONFIGS["davis"], **SMALL))


def test_eval_tapvid_equals_the_loop_without_read_ahead(tmp_path, small_davis):
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, build_tracker, eval_tapvid
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

    _write_pickles(str(tmp_path))
    ds = TapVidDataset(str(tmp_path), input_size=(H, W))
    tracker = build_tracker(TASK_CONFIGS["davis"], device="cpu")
    results = []
    for i in range(len(ds)):  # the loop before the read-ahead
        s = ds[i]
        out = tracker.track_points(s["video"], s["query_points"])
        results.append({"trajectories_gt": s["trajectories"],
                        "visibilities_gt": s["visibilities"],
                        "trajectories_pred": out["trajectories"],
                        "visibilities_pred": out["visibilities"],
                        "query_points": s["query_points"]})
    expect = ds.evaluate(results, indices=range(len(ds)))
    assert eval_tapvid(tracker, ds) == expect


class _TinyDavis:
    """Two 4-frame videos at 32 x 32 with a two-object first mask; keeps
    each video's predicted label maps."""

    def __init__(self, seed=5):
        rng = np.random.default_rng(seed)
        self.videos = [rng.integers(0, 256, (4, H, W, 3), dtype=np.uint8) for _ in range(2)]
        mask = np.zeros((H, W), np.uint8)
        mask[8:20, 10:24] = 1
        mask[22:30, 2:10] = 2
        self.gt = [np.stack([mask] * 4) for _ in range(2)]
        self.preds = []

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, i):
        return {"video": self.videos[i], "first_mask": self.gt[i][0],
                "original_shape": (H, W), "num_objects": 2}

    def score_video(self, i, pred):
        from fgvc_tpu_torch.datasets.davis_vos import score_masks

        self.preds.append((i, pred))
        return score_masks(self.gt[i], pred)


def test_eval_vos_equals_the_loop_without_read_ahead():
    from fgvc_tpu_torch.apis.test import build_tracker, eval_vos
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.core.metrics.vos import aggregate_jf

    ds = _TinyDavis()
    tracker = build_tracker(dataclasses.replace(DAVIS_TEST_CFG, **VOS), device="cpu")
    stats, preds = [], []
    for i in range(len(ds)):  # the loop before the read-ahead
        s = ds[i]
        masks = tracker.track_masks(s["video"], s["first_mask"], s["original_shape"], 2)
        preds.append(masks)
        stats.append(ds.score_video(i, masks))
    expect = aggregate_jf(stats)
    ds.preds = []
    assert eval_vos(tracker, ds) == expect
    assert [i for i, _ in ds.preds] == [0, 1]
    for (_, got), want in zip(ds.preds, preds):
        np.testing.assert_array_equal(got, want)


def test_cli_profile_writes_a_trace_with_the_spans(tmp_path, small_davis, capsys):
    """`python -m fgvc_tpu_torch.cli.test --task davis --device cpu
    --profile LOGDIR`: the metrics of the run without --profile, and a trace
    holding the harness's spans."""
    from fgvc_tpu_torch.cli.test import main

    _write_pickles(str(tmp_path), n=1)
    results = []
    for extra in ([], ["--profile", str(tmp_path / "prof")]):
        main(["--task", "davis", "--data-root", str(tmp_path), "--device", "cpu",
              "--output-dir", str(tmp_path / "out"), *extra])
        printed = capsys.readouterr().out
        results.append(json.loads(printed[printed.index("{"):]))
    assert results[1] == results[0]
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"propagate[0]", "collect[0]"} <= names


def test_pass_breakdown_runs_the_plain_cuts_on_the_cpu(capsys):
    """`python -m fgvc_tpu_torch.bench.pass_breakdown --device cpu --size
    16 --channels 16`: the JAX tool's lines per mode and one JSON line whose
    split adds up, with no device numbers."""
    from fgvc_tpu_torch.bench.pass_breakdown import main

    main(["--device", "cpu", "--size", "16", "--channels", "16", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0].strip() for ln in lines[1:4]] == ["float32", "high", "bfloat16"]
    res = json.loads(lines[-1])
    assert res["card"] is None and res["device_ms_by_kernel"] is None
    assert res["clock"] == "host" and res["channels"] == 16
    for t in res["ms"].values():
        assert t["A"] + t["B"] + t["C"] == pytest.approx(t["total"])
        assert t["A"] == t["a"] and t["total"] == t["abc"]


@pytest.mark.parametrize("name", ["topk_attention", "mxu_vpu_overlap"])
def test_ablate_cuts_are_in_the_kernel_sources(name):
    """`python -m fgvc_tpu_torch.bench.ablate` cuts each part it times out
    of the current source, once: every variant differs from the source in
    that one place."""
    from fgvc_tpu_torch.bench import ablate

    variants = ablate.variant_sources(name)
    assert list(variants) == ["full", *ablate.CUTS[name]]
    for variant, text in variants.items():
        assert (text == variants["full"]) == (variant == "full")
