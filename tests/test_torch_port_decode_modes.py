"""The decode options of the port's Tracker against the JAX Tracker with
attention_impl 'pallas' (its kernel interpreted on the CPU), at the small
sizes of tests/test_torch_port_tracker.py: visibility_mode 'heatmap' with
each decode_impl ('upsample', 'window', which decodes as 'upsample', and
'coarse', the feature-resolution soft-argmax scaled to the input size).

Trajectories agree within 1e-3 px and each frame's peak within 1e-5
relative (float32 sums through the backbone and the attention).  A
visibility is the peak ratio thresholded, so it may differ only where the
JAX ratio lies within 1e-5 of the threshold; the test counts those.  Then
run_task('davis') with heatmap visibility against the JAX harness (every
metric within 1e-6), S = 2 CPU row blocks against the unsharded run (bit for
bit), the refusals, and the CLI flags.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data
from test_torch_port_tracker import SMALL, H, T, W, _video

DECODES = ("upsample", "window", "coarse")
TIE_BAND = 1e-5
# random features keep each peak at 0.84-0.97 of its query frame's over these
# 8 frames: a threshold inside that range predicts both outcomes
THRESHOLD = 0.92


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    import jax

    from fgvc_tpu.models.resnet import init_resnet_params
    from fgvc_tpu.models.resnet import resnet18_d1 as flax_resnet18_d1
    from fgvc_tpu_torch.models.resnet import resnet18_d1
    from fgvc_tpu_torch.models.weights import load_weights, state_dict_from_flax

    rng = np.random.default_rng(0)
    video = _video(rng)
    # two query-frame groups; points near the border leave the view
    query_points = np.array(
        [[0, 10.3, 12.7], [0, 28.6, 8.2], [0, 15.1, 30.9], [3, 12.4, 14.8], [3, 1.5, 2.5]],
        dtype=np.float32,
    )
    model = flax_resnet18_d1()
    variables = init_resnet_params(model, jax.random.PRNGKey(0), (H, W))
    port_model = load_weights(resnet18_d1(), state_dict_from_flax(variables))
    return model, variables, port_model, video, query_points


def _port_tracker(port_model, spatial_devices=None, **cfg):
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.models.tracker import Tracker

    return Tracker(port_model, dataclasses.replace(DAVIS_TEST_CFG, **SMALL, **cfg),
                   torch.device("cpu"), spatial_devices=spatial_devices)


def _peaks(disp, T_video):
    """{query frame: (T', n) peaks} of a dispatched video (either package)."""
    return {int(t): np.asarray(rows)[: T_video - int(t), : len(sel), 2]
            for t, sel, rows in disp["pending"]}


@pytest.mark.parametrize("decode_impl", DECODES)
def test_heatmap_visibility_matches_jax(weights, decode_impl):
    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.models.tracker import Tracker as JaxTracker

    model, variables, port_model, video, query_points = weights
    knobs = dict(visibility_mode="heatmap", visibility_threshold=THRESHOLD,
                 decode_impl=decode_impl)
    jax_cfg = JaxTestConfig(**SMALL, **knobs, frame_bucket=8, point_bucket=4,
                            attention_impl="pallas")
    jax_tracker = JaxTracker(lambda v, x: model.apply(v, x, train=False), variables, jax_cfg)
    jax_disp = jax_tracker.track_points_dispatch(video, query_points)
    ref = jax_tracker.track_points_collect(jax_disp)
    tracker = _port_tracker(port_model, **knobs)
    disp = tracker.track_points_dispatch(video, query_points)
    out = tracker.track_points_collect(disp)

    assert out["trajectories"].shape == (T, 5, 2)
    np.testing.assert_allclose(out["trajectories"], ref["trajectories"], rtol=0, atol=1e-3)
    ref_peaks, peaks = _peaks(jax_disp, T), _peaks(disp, T)
    assert sorted(peaks) == sorted(ref_peaks) == [0, 3]
    ties = 0
    for t in peaks:
        np.testing.assert_allclose(peaks[t], ref_peaks[t], rtol=1e-5, atol=0)
        sel = query_points[:, 0] == t
        ratio = ref_peaks[t] / np.maximum(ref_peaks[t][0], 1e-12)
        near = np.abs(ratio - THRESHOLD) <= TIE_BAND
        ties += int(near.sum())
        np.testing.assert_array_equal(out["visibilities"][t:, sel][~near],
                                      ref["visibilities"][t:, sel][~near])
    assert ties == 0, f"{ties} (frame, point) pairs within {TIE_BAND} of the threshold"
    # frames before a point's query frame are never visible
    assert not out["visibilities"][:3, 3:].any()
    assert out["visibilities"].any() and not out["visibilities"][3:].all()


def test_window_decodes_as_upsample(weights):
    port_model, video, query_points = weights[2], weights[3], weights[4]
    a, b = (_port_tracker(port_model, visibility_mode="heatmap", visibility_threshold=THRESHOLD,
                          decode_impl=d)
            .track_points(video, query_points) for d in ("upsample", "window"))
    np.testing.assert_array_equal(a["trajectories"], b["trajectories"])
    np.testing.assert_array_equal(a["visibilities"], b["visibilities"])


def test_row_blocks_equal_unsharded(weights):
    """S = 2 CPU row blocks (K4's path) with heatmap visibility and the
    coarse decode: the unsharded run's trajectories and visibilities bit
    for bit."""
    port_model, video, query_points = weights[2], weights[3], weights[4]
    cfg = dict(visibility_mode="heatmap", visibility_threshold=THRESHOLD, decode_impl="coarse")
    single = _port_tracker(port_model, **cfg).track_points(video, query_points)
    sp = _port_tracker(port_model, spatial_devices=["cpu", "cpu"], **cfg).track_points(
        video, query_points)
    np.testing.assert_array_equal(sp["trajectories"], single["trajectories"])
    np.testing.assert_array_equal(sp["visibilities"], single["visibilities"])


@pytest.mark.parametrize("decode_impl", ["upsample", "coarse"])
def test_run_task_heatmap_matches_jax(tmp_path_factory, decode_impl):
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task

    base = tmp_path_factory.mktemp("decode_run_task")
    root = data.make_tapvid(str(base / "davis"), seed=31, T=8, size=(H, W))
    pth = data.export_pth(base / "weights.pth", (H, W))
    knobs = dict(SMALL, input_size=(H, W), visibility_mode="heatmap",
                 visibility_threshold=THRESHOLD, decode_impl=decode_impl)
    ref = jax_run_task("davis", root, checkpoint=pth, test_cfg=dataclasses.replace(
        JAX_TASK_CONFIGS["davis"], **knobs, frame_bucket=8, point_bucket=4,
        attention_impl="pallas"))
    out = run_task("davis", root, checkpoint=pth, device="cpu",
                   test_cfg=dataclasses.replace(TASK_CONFIGS["davis"], **knobs))
    assert 0 < out["occlusion_accuracy"] < 100
    for k in sorted(set(ref) & set(out)):
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_bad_decode_knobs_raise():
    from fgvc_tpu_torch.apis.test import build_tracker
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG

    for knob, value, match in [("visibility_mode", "softmax", "visibility_mode"),
                               ("decode_impl", "bicubic", "decode_impl")]:
        with pytest.raises(ValueError, match=match):
            build_tracker(dataclasses.replace(DAVIS_TEST_CFG, **{knob: value}), device="cpu")


def test_cli_overlays_decode_flags_and_model(monkeypatch, capsys, tmp_path):
    """--model, --decode-impl, --visibility-mode and --visibility-threshold
    reach run_task over the task preset, explicit flags over --config."""
    import json

    import fgvc_tpu_torch.apis.test as api
    from fgvc_tpu_torch.cli.test import main

    seen = {}
    monkeypatch.setattr(api, "run_task", lambda task, root, **kw: seen.update(kw) or {})
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"visibility_threshold": 0.7, "decode_impl": "window"}))
    main(["--task", "davis", "--data-root", ".", "--device", "cpu", "--config", str(cfg_file),
          "--visibility-mode", "heatmap"])
    cfg = seen["test_cfg"]
    assert (cfg.visibility_mode, cfg.visibility_threshold, cfg.decode_impl) == (
        "heatmap", 0.7, "window")
    assert seen["model"] == "vanilla"
    main(["--task", "kinetics", "--data-root", ".", "--device", "cpu", "--model", "raft",
          "--decode-impl", "coarse", "--visibility-threshold", "0.25"])
    capsys.readouterr()
    cfg = seen["test_cfg"]
    assert (cfg.visibility_mode, cfg.visibility_threshold, cfg.decode_impl) == (
        "none", 0.25, "coarse")
    assert seen["model"] == "raft"
