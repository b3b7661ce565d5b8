"""The port's reproduction CLI (fgvc_tpu_torch/cli/reproduce.py) against the
JAX package's (fgvc_tpu/cli/reproduce.py), both on the CPU over the tiny
TAP-Vid, Kinetics, JHMDB and BADJA trees and the exported ResNet-18-d1
``.pth`` of tests/test_torch_port_eval_run_task.py, each package's
TASK_CONFIGS cut to the same small windows (BADJA's reader to 32 x 48):

* every task value and shared metric of report.json, and the three fast
  modes, within 1e-6 of the JAX CLI's, both feature-parity probes below
  1e-3, the same report.md table, and the first video's track render;
* a negative BatchNorm variance in the .pth: both CLIs exit 2 before any
  task; with --force the port runs on and reports the failed probe;
* TF32 is off inside the probe's forward whatever it was before;
* exit 1 against the published numbers (seeded weights miss them), exit 0
  against EXPECTED patched to the values reached;
* the harness's track render is best-effort: a failing writer prints one
  line and leaves the metrics as they were.

The JAX CLI runs once for the module.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data

H = W = 32
SMALL = dict(neighbor_range=8, tile=8)
SMALL_READER = (32, 48)
TOL = 1e-6
TASK_ROOTS = {"davis": "--davis-root", "kinetics": "--kinetics-root",
              "jhmdb": "--jhmdb-root", "badja": "--badja-root"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The trees, the .pth, and both packages' configurations, probes and
    BADJA readers made small for the module."""
    import jax

    import fgvc_tpu.apis.test as jax_harness
    import fgvc_tpu.cli.reproduce as jax_rep
    import fgvc_tpu.datasets.badja as jax_badja
    import fgvc_tpu_torch.apis.test as harness
    import fgvc_tpu_torch.cli.reproduce as rep
    import fgvc_tpu_torch.datasets.badja as badja

    base = tmp_path_factory.mktemp("reproduce")
    trees = {
        "davis": data.make_tapvid(str(base / "davis"), seed=11, T=8, size=(H, W)),
        "kinetics": data.make_tapvid(str(base / "kinetics"), seed=10, T=9, size=(40, 56),
                                     jpeg=True, nested=True),
        "jhmdb": data.make_jhmdb(str(base / "jhmdb"), seed=12),
        "badja": data.make_badja(str(base / "badja"), seed=13),
    }
    pth = data.export_pth(base / "weights.pth", (H, W))
    mp = pytest.MonkeyPatch()
    for task in TASK_ROOTS:
        mp.setitem(jax_harness.TASK_CONFIGS, task, dataclasses.replace(
            jax_harness.TASK_CONFIGS[task], **SMALL, input_size=(H, W), frame_bucket=8,
            point_bucket=4, attention_impl="pallas"))
        mp.setitem(harness.TASK_CONFIGS, task, dataclasses.replace(
            harness.TASK_CONFIGS[task], **SMALL, input_size=(H, W)))
    for mod in (jax_badja, badja):
        class SmallBadja(mod.BadjaDataset):
            def __init__(self, root, list_path):
                super().__init__(root, list_path, size=SMALL_READER)

        mp.setattr(mod, "BadjaDataset", SmallBadja)
    jax_probe, probe = jax_rep.parity_probe, rep.parity_probe
    mp.setattr(jax_rep, "parity_probe", lambda c: jax_probe(c, frames=1, size=64))
    mp.setattr(rep, "parity_probe", lambda c, device=None: probe(c, frames=1, size=64,
                                                                 device=device))
    # the JAX CLI points jax at its own compilation cache; the suite keeps its own
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield dict(trees=trees, pth=pth, base=base, probe=probe)
    jax.config.update("jax_compilation_cache_dir", cache[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", cache[1])
    mp.undo()


def _argv(small, out, pth=None, tasks=TASK_ROOTS, extra=()):
    argv = ["--checkpoint", pth or small["pth"], "--output-dir", str(out), "--max-videos", "1"]
    for task in tasks:
        argv += [TASK_ROOTS[task], small["trees"][task]]
    return argv + list(extra)


def _run_jax(argv, monkeypatch):
    from fgvc_tpu.cli.reproduce import main

    monkeypatch.setattr(sys, "argv", ["reproduce", *argv, "--platform", "cpu"])
    with pytest.raises(SystemExit) as e:
        main()
    return e.value.code


def _run_port(argv):
    from fgvc_tpu_torch.cli.reproduce import main

    try:
        main([*argv, "--device", "cpu"])
    except SystemExit as e:
        return e.code
    return 0


@pytest.fixture(scope="module")
def jax_run(small):
    mp = pytest.MonkeyPatch()
    out = small["base"] / "jax_out"
    code = _run_jax(_argv(small, out, extra=["--fast-modes"]), mp)
    mp.undo()
    with open(out / "report.json") as f:
        return code, json.load(f), (out / "report.md").read_text()


def test_report_matches_the_jax_cli(small, jax_run, capsys):
    jax_code, ref, ref_md = jax_run
    out = small["base"] / "port_out"
    code = _run_port(_argv(small, out, extra=["--fast-modes"]))
    assert code == jax_code == 1  # seeded weights miss the published numbers
    with open(out / "report.json") as f:
        got = json.load(f)
    assert got["feature_parity"]["max_abs"] < 1e-3 and got["feature_parity"]["ok"]
    assert ref["feature_parity"]["max_abs"] < 1e-3 and ref["feature_parity"]["ok"]
    assert got["feature_parity"]["unexpected_keys"] == ref["feature_parity"]["unexpected_keys"]
    assert sorted(got["tasks"]) == sorted(ref["tasks"]) == sorted(TASK_ROOTS)
    for task, r in ref["tasks"].items():
        g = got["tasks"][task]
        assert (g["metric"], g["expected"], g["within_bar"]) == (
            r["metric"], r["expected"], r["within_bar"]), task
        for k in ("value", "delta"):
            np.testing.assert_allclose(g[k], r[k], rtol=TOL, atol=TOL, err_msg=f"{task} {k}")
        shared = sorted(set(g["all_metrics"]) & set(r["all_metrics"]))
        assert r["metric"] in shared
        for k in shared:
            np.testing.assert_allclose(g["all_metrics"][k], r["all_metrics"][k], rtol=TOL,
                                       atol=TOL, err_msg=f"{task} {k}")
    assert sorted(got["fast_modes"]) == sorted(ref["fast_modes"])
    for name, r in ref["fast_modes"].items():
        for k in ("value", "delta_vs_exact"):
            np.testing.assert_allclose(got["fast_modes"][name][k], r[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {k}")
    assert (out / "report.md").read_text() == ref_md
    assert "| davis | average_pts_within_thresh |" in capsys.readouterr().out
    # the harness's render of the first video, readable by the port's reader
    from fgvc_tpu_torch.utils.visualize import read_video

    frames, fps = read_video(str(out / "davis" / "tracks_0000.mp4"))
    assert frames.shape == (8, H, W, 3) and fps == 24


def _corrupt_pth(src, dst):
    blob = torch.load(src, map_location="cpu", weights_only=True)
    state = blob["state_dict"]
    key = "backbone.layer2.0.conv1.bn.running_var"
    state[key] = state[key].clone()
    state[key][3] = -1.0  # a negative variance: NaN features downstream
    torch.save(blob, dst)
    return str(dst)


def test_failed_probe_exits_2_as_in_jax_and_force_runs_on(small, monkeypatch):
    bad = _corrupt_pth(small["pth"], small["base"] / "bad.pth")
    out = small["base"] / "bad_out"
    assert _run_jax(_argv(small, small["base"] / "bad_jax", pth=bad, tasks=()), monkeypatch) == 2
    assert _run_port(_argv(small, out, pth=bad, tasks=("davis",))) == 2
    assert not (out / "report.json").exists()
    assert _run_port(_argv(small, out, pth=bad, tasks=("davis",), extra=["--force"])) == 1
    with open(out / "report.json") as f:
        report = json.load(f)
    assert not report["feature_parity"]["ok"]
    assert list(report["tasks"]) == ["davis"]


def test_probe_runs_with_tf32_off(small, monkeypatch):
    from fgvc_tpu_torch.models.resnet import ResNet

    seen = []
    forward = ResNet.forward

    def spy(self, x):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return forward(self, x)

    monkeypatch.setattr(ResNet, "forward", spy)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        probe = small["probe"](small["pth"], frames=1, size=32, device="cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert seen == [(False, False)]
    assert probe["ok"] and probe["unexpected_keys"] == 0


def test_exit_codes_follow_the_bar(small, jax_run, monkeypatch):
    import fgvc_tpu_torch.cli.reproduce as rep

    _, ref, _ = jax_run
    out = small["base"] / "bar_out"
    argv = _argv(small, out, tasks=("jhmdb", "badja"), extra=["--skip-parity"])
    assert _run_port(argv) == 1
    reached = {t: (ref["tasks"][t]["metric"], ref["tasks"][t]["value"]) for t in TASK_ROOTS}
    monkeypatch.setattr(rep, "EXPECTED", reached)
    assert _run_port(argv) == 0
    with open(out / "report.json") as f:
        report = json.load(f)
    assert "feature_parity" not in report
    assert all(t["within_bar"] for t in report["tasks"].values())


def test_track_render_is_best_effort(small, jax_run, monkeypatch, capsys, tmp_path):
    """A failing render prints one line naming the error and changes no
    metric of run_task('davis')."""
    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.utils import visualize

    def broken(frames, path, fps=24):
        raise OSError("disk full")

    monkeypatch.setattr(visualize, "save_video", broken)
    out = run_task("davis", small["trees"]["davis"], checkpoint=small["pth"], max_videos=1,
                   output_dir=str(tmp_path), device="cpu")
    assert "[render] tracks_0000.mp4 not written: OSError: disk full" in capsys.readouterr().out
    assert not (tmp_path / "tracks_0000.mp4").exists()
    ref = jax_run[1]["tasks"]["davis"]["all_metrics"]
    for k in set(ref) & set(out):
        np.testing.assert_allclose(out[k], ref[k], rtol=TOL, atol=TOL, err_msg=k)
