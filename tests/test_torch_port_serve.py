"""The port's serving entry point (fgvc_tpu_torch/cli/serve.py) against
fgvc_tpu's (fgvc_tpu/cli/serve.py), over the same HTTP requests to both
servers on ephemeral ports: the port's Tracker on the CPU, the JAX Tracker
with attention_impl 'pallas' (its kernel interpreted on the CPU), both from
one flax ResNet-18-d1 init, at the small sizes of
tests/test_torch_port_tracker.py with heatmap visibility.

/v1/track trajectories agree within 1e-3 px (float32 sums through the
backbone and the attention) and equal the port's direct track_points call;
a visibility may differ from JAX's only where the port's peak ratio lies
within 1e-5 of the threshold.  /v1/vos masks equal JAX's label for label.
The host resize equals fgvc_tpu serve's cv2 resize bit for bit.  Errors
(400, 404, 413) and build_serve_cfg's layering are JAX's.  Two concurrent
requests each get their serial answer.
"""

import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_port_decode_modes import THRESHOLD, TIE_BAND
from test_torch_port_tracker import SMALL, H, W, _video

SERVE = dict(SMALL, visibility_mode="heatmap", visibility_threshold=THRESHOLD)
TRAJ_TOL_PX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _start(make_server, tracker):
    srv, stats = make_server(tracker, 0, {"backbone": "resnet18_d1", "max_request_mb": 512})
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, stats


@pytest.fixture(scope="module")
def servers():
    """{'jax': (server, stats, tracker), 'port': (...)}."""
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASKS
    from fgvc_tpu.apis.test import build_tracker as jax_build_tracker
    from fgvc_tpu.cli.serve import make_server as jax_make_server
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS
    from fgvc_tpu_torch.cli.serve import make_server
    from fgvc_tpu_torch.models.resnet import resnet18_d1
    from fgvc_tpu_torch.models.tracker import Tracker
    from fgvc_tpu_torch.models.weights import load_weights, state_dict_from_flax

    jax_tracker = jax_build_tracker(dataclasses.replace(
        JAX_TASKS["davis"], **SERVE, frame_bucket=8, point_bucket=4, attention_impl="pallas"))
    model = load_weights(resnet18_d1(), state_dict_from_flax(jax_tracker.variables))
    tracker = Tracker(model, dataclasses.replace(TASK_CONFIGS["davis"], **SERVE),
                      torch.device("cpu"))
    out = {"jax": (*_start(jax_make_server, jax_tracker), jax_tracker),
           "port": (*_start(make_server, tracker), tracker)}
    yield out
    for srv, _, _ in out.values():
        srv.shutdown()
        srv.server_close()


def _post(srv, path="/v1/track", **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}{path}",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def _error(fn, *args, **kw):
    """(status, error message) of a request that must fail."""
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn(*args, **kw)
    return ei.value.code, json.loads(ei.value.read())["error"]


PTS = np.array([[0, 10.3, 12.7], [0, 20.6, 8.2], [2, 12.4, 14.8]], np.float32)


def _peak_ratios(tracker, video, pts):
    """(T, P) peak ratios of the port's decode (NaN before a query frame)."""
    disp = tracker.track_points_dispatch(video, pts)
    ratios = np.full((video.shape[0], pts.shape[0]), np.nan)
    for t, sel, rows in disp["pending"]:
        ratios[t:, sel] = tracker.peak_ratios(rows.numpy())
    return ratios


def _check_visibilities(vis, ref, ratios):
    differ = vis != ref
    assert np.all(np.abs(ratios[differ] - THRESHOLD) <= TIE_BAND), np.argwhere(differ)


def test_track_matches_jax_and_the_direct_call(servers):
    video = _video(np.random.default_rng(0))
    ref = _post(servers["jax"][0], video=video, query_points=PTS)
    srv, stats, tracker = servers["port"]
    before = stats["requests"]
    out = _post(srv, video=video, query_points=PTS)
    traj = np.asarray(out["trajectories"])
    vis = np.asarray(out["visibilities"])
    assert traj.shape == (len(video), len(PTS), 2) and out["ms"] > 0
    assert np.abs(traj - np.asarray(ref["trajectories"])).max() <= TRAJ_TOL_PX
    direct = tracker.track_points(video, PTS)
    np.testing.assert_array_equal(traj, direct["trajectories"].astype(np.float64))
    np.testing.assert_array_equal(vis, direct["visibilities"])
    assert 0 < vis.mean() < 1  # the threshold predicts both outcomes here
    _check_visibilities(vis, np.asarray(ref["visibilities"]), _peak_ratios(tracker, video, PTS))
    assert _get(srv, "/healthz")["status"] == "ok"
    st = _get(srv, "/stats")
    assert st["requests"] == before + 1 and st["frames"] >= len(video)
    assert set(st) == set(_get(servers["jax"][0], "/stats"))


def test_host_resize_equals_jax_serve_cv2():
    from fgvc_tpu.cli.serve import _resize_video
    from fgvc_tpu_torch.datasets.image_io import resize_frames

    rng = np.random.default_rng(5)
    for shape, hw in (((3, 48, 96, 3), (32, 32)), ((2, 480, 854, 3), (256, 256)),
                      ((2, 20, 28, 3), (32, 32))):
        video = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(resize_frames(video, hw), _resize_video(video, hw))


def test_offsize_video_is_resized_and_scaled_as_jax(servers):
    from fgvc_tpu_torch.datasets.image_io import resize_frames

    small = _video(np.random.default_rng(1))
    video = np.repeat(np.repeat(small, 2, axis=1), 3, axis=2)  # 64 x 96
    pts = PTS * np.array([1, 3, 2], np.float32)
    ref = _post(servers["jax"][0], video=video, query_points=pts)
    srv, _, tracker = servers["port"]
    traj = np.asarray(_post(srv, video=video, query_points=pts)["trajectories"])
    assert traj.shape == (len(video), len(pts), 2)
    assert np.abs(traj - np.asarray(ref["trajectories"])).max() <= 3 * TRAJ_TOL_PX
    # the same request by hand at the model's resolution, scaled out
    spts = pts.copy()
    spts[:, 1] *= W / 96
    spts[:, 2] *= H / 64
    direct = tracker.track_points(resize_frames(video, (H, W)), spts)["trajectories"]
    direct = direct.astype(np.float64) * np.array([96 / W, 64 / H])
    np.testing.assert_array_equal(traj, direct)


def test_vos_masks_equal_jax(servers):
    rng = np.random.default_rng(4)
    video = _video(rng)[:4]
    mask0 = np.zeros((H, W), np.uint8)
    mask0[4:14, 6:18] = 1
    mask0[18:28, 2:10] = 2
    ref = _post(servers["jax"][0], "/v1/vos", video=video, first_mask=mask0)
    srv, _, tracker = servers["port"]
    out = _post(srv, "/v1/vos", video=video, first_mask=mask0)
    masks = np.asarray(out["masks"])
    assert masks.shape == (4, H, W) and out["num_objects"] == ref["num_objects"] == 2
    np.testing.assert_array_equal(masks, np.asarray(ref["masks"]))
    np.testing.assert_array_equal(masks, tracker.track_masks(video, mask0, (H, W), 2))
    np.testing.assert_array_equal(masks[0], mask0)
    # off-size: frames resized to the model's, masks at the client's size
    big = np.repeat(video, 2, axis=1)
    big_mask = np.repeat(mask0, 2, axis=0)
    ref = _post(servers["jax"][0], "/v1/vos", video=big, first_mask=big_mask)
    masks = np.asarray(_post(srv, "/v1/vos", video=big, first_mask=big_mask)["masks"])
    assert masks.shape == (4, 2 * H, W)
    np.testing.assert_array_equal(masks, np.asarray(ref["masks"]))


def test_errors_are_jax_errors(servers):
    rng = np.random.default_rng(3)
    bad = {
        "no channel": dict(video=rng.integers(0, 256, (3, H, W), dtype=np.uint8),
                           query_points=np.zeros((1, 3), np.float32)),
        "off-size float": dict(video=np.zeros((2, 48, 48, 3), np.float32),
                               query_points=np.zeros((1, 3), np.float32)),
        "points": dict(video=rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8),
                       query_points=np.zeros((3,), np.float32)),
    }
    for name, arrays in bad.items():
        got = {side: _error(_post, servers[side][0], **arrays) for side in ("jax", "port")}
        assert got["port"][0] == got["jax"][0] == 400, name
    assert "resized" in _error(_post, servers["port"][0], **bad["off-size float"])[1]
    assert "video must be" in _error(_post, servers["port"][0], **bad["no channel"])[1]
    vos_bad = dict(video=rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8),
                   first_mask=np.zeros((H + 1, W), np.uint8))
    for side in ("jax", "port"):
        srv = servers[side][0]
        assert _error(_post, srv, "/v1/vos", **vos_bad)[0] == 400
        assert _error(_post, srv, "/v1/nothing", **bad["no channel"])[0] == 404
        assert _error(_get, srv, "/nothing")[0] == 404
        assert _get(srv, "/healthz")["status"] == "ok"  # still alive


def test_oversize_request_is_a_413(servers):
    small = dict(video=np.zeros((2, H, W, 3), np.uint8), query_points=np.zeros((1, 3), np.float32))
    for side in ("jax", "port"):
        srv, stats, _ = servers[side]
        stats["config"]["max_request_mb"] = 0
        try:
            code, msg = _error(_post, srv, **small)
            assert code == 413 and "max_request_mb" in msg
            code, msg = _error(_post, srv, "/v1/vos", video=small["video"],
                               first_mask=np.zeros((H, W), np.uint8))
            assert code == 413
        finally:
            stats["config"]["max_request_mb"] = 512


def test_concurrent_requests_get_their_serial_answers(servers):
    srv, _, _ = servers["port"]
    rng = np.random.default_rng(6)
    reqs = [dict(video=_video(rng)[:5], query_points=PTS[:2]),
            dict(video=_video(rng)[:6], query_points=PTS)]
    serial = [_post(srv, **r) for r in reqs]
    got = [None, None]

    def post(i):
        got[i] = _post(srv, **reqs[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for g, s in zip(got, serial):
        assert g["trajectories"] == s["trajectories"]
        assert g["visibilities"] == s["visibilities"]


@pytest.mark.parametrize("argv,config", [
    ([], None), (["--input-size", "64"], None), (["--precision", "high"], None),
    (["--visibility-mode", "none"], None),
    ([], {"visibility_mode": "none"}), ([], {"input_size": [96, 96], "topk": 5}),
    (["--input-size", "64", "--visibility-mode", "heatmap"], {"visibility_mode": "none"}),
])
def test_build_serve_cfg_layers_as_jax(tmp_path, argv, config):
    from fgvc_tpu.cli.serve import build_serve_cfg as jax_build_serve_cfg
    from fgvc_tpu_torch.cli.serve import build_parser, build_serve_cfg

    if config is not None:
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(config))
        argv = [*argv, "--config", str(path)]
    args = build_parser().parse_args(argv)
    cfg, ref = build_serve_cfg(args), jax_build_serve_cfg(args)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name


def test_serve_tracker_warms_on_the_named_device(monkeypatch):
    from fgvc_tpu_torch.cli.serve import build_parser, serve_tracker

    args = build_parser().parse_args(["--device", "cpu", "--input-size", "32"])
    tracker, summary = serve_tracker(args)
    assert summary["platform"] == "cpu" and summary["input_size"] == (32, 32)
    assert tracker.cfg.visibility_mode == "heatmap"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_tracker(build_parser().parse_args([]))
