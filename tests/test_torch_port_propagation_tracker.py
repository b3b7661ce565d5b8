"""The propagation modes end to end: the port's Tracker (attention_impl
'tiled' with its top-k implementations, 'dense', 'c2f', 'flow_guided',
with_first_neighbor=False, forward-warp tracking, VOS banked and save_mem,
spatial-parallel 'tiled'), its harness and its CLI on the CPU against the
JAX package's.

The Tracker tests run both packages over one tiny encoder, written twice
(2 x 2 patches of the Lab frame, a seeded 12 x 16 projection, tanh): a 32 x
32 video gives 16 x 16 x 16 features, so the JAX side traces in about a
second a mode.  Trajectories agree within 1e-3 px, label maps label for
label, spatial-parallel row blocks equal the unsharded run.  run_task('davis')
runs the paper's ResNet-18-d1 on one MOVi scene, as tests/
test_torch_port_run_task.py does, with metrics within 1e-6 of the JAX
harness.  Every refusal of the JAX Tracker's raises ValueError here too.
"""

import dataclasses
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from torch import nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 32
T = 6
C = 16
SMALL = dict(input_size=(H, W), neighbor_range=8, tile=8, radius_fine=3, flow_radius=2,
             c2f_step=7, flow_step=50, step=60)
TRAJ_TOL_PX = 1e-3
METRIC_TOL = 1e-6
# groups at frames 0, 2 and the last frame (nothing to propagate)
QUERY_POINTS = np.array([[0, 10.3, 12.7], [0, 20.6, 8.2], [0, 15.1, 22.9], [2, 12.4, 14.8],
                         [T - 1, 16.2, 9.7]], dtype=np.float32)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here: the suite's six workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _video(rng):
    """Smooth texture panning one pixel a frame, uint8."""
    size = H + 2 * T
    noise = rng.standard_normal((size, size, 3))
    k = np.fft.fftfreq(size)
    f = np.fft.fft2(noise, axes=(0, 1)) * np.exp(-(k[:, None] ** 2 + k[None] ** 2) * 60.0)[..., None]
    tex = np.real(np.fft.ifft2(f, axes=(0, 1)))
    tex = ((tex - tex.min()) / (tex.max() - tex.min()) * 255).astype(np.uint8)
    return np.stack([tex[t:t + H, t:t + W] for t in range(T)])


def _mask():
    m = np.zeros((H, W), np.int32)
    m[8:20, 6:18] = 1
    m[22:30, 20:30] = 2
    return m


def _jax_encoder(proj, x):
    """The JAX side of the tiny encoder: (N, H, W, 3) -> (N, H/2, W/2, C)."""
    import jax.numpy as jnp

    N, h2, w2, _ = x.shape
    p = x.reshape(N, h2 // 2, 2, w2 // 2, 2, 3).transpose(0, 1, 3, 2, 4, 5)
    return jnp.tanh(p.reshape(N, h2 // 2, w2 // 2, 12) @ proj)


class PatchEncoder(nn.Module):
    """The port's side of the tiny encoder: (N, 3, H, W) -> (N, C, H/2, W/2)."""

    def __init__(self, proj):
        super().__init__()
        self.proj = nn.Parameter(torch.from_numpy(proj))

    def forward(self, x):
        N, _, h2, w2 = x.shape
        p = x.permute(0, 2, 3, 1).reshape(N, h2 // 2, 2, w2 // 2, 2, 3).permute(0, 1, 3, 2, 4, 5)
        return torch.tanh(p.reshape(N, h2 // 2, w2 // 2, 12) @ self.proj).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    video = _video(rng)
    proj = (rng.standard_normal((12, C)) / 2).astype(np.float32)
    return video, proj


def _jax_tracker(proj, **cfg):
    import jax.numpy as jnp

    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu.models.tracker import Tracker as JaxTracker

    return JaxTracker(_jax_encoder, jnp.asarray(proj),
                      JaxTestConfig(**SMALL, frame_bucket=8, point_bucket=4, **cfg))


def _port_tracker(proj, S=None, **cfg):
    from fgvc_tpu_torch.config import TestConfig
    from fgvc_tpu_torch.models.tracker import Tracker

    cpu = torch.device("cpu")
    return Tracker(PatchEncoder(proj), TestConfig(**SMALL, **cfg), cpu,
                   spatial_devices=None if S is None else [cpu] * S)


MODES = {
    "tiled": dict(attention_impl="tiled"),
    "tiled_segmented": dict(attention_impl="tiled", topk_impl="segmented"),
    "dense": dict(attention_impl="dense"),
    "c2f": dict(attention_impl="c2f"),
    "flow_guided": dict(attention_impl="flow_guided"),
    "first_neighbor_off": dict(attention_impl="pallas", with_first_neighbor=False),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_track_points_matches_jax(setup, mode):
    video, proj = setup
    ref = _jax_tracker(proj, **MODES[mode]).track_points(video, QUERY_POINTS)
    tracker = _port_tracker(proj, **MODES[mode])
    out = tracker.track_points(video, QUERY_POINTS)
    assert out["trajectories"].shape == (T, 5, 2) and not out["visibilities"].any()
    np.testing.assert_array_equal(out["trajectories"][:2, 3], 0.0)  # before its query
    np.testing.assert_allclose(out["trajectories"], ref["trajectories"], rtol=0,
                               atol=TRAJ_TOL_PX)


def test_track_points_forward_matches_jax(setup):
    video, proj = setup
    ref = _jax_tracker(proj).track_points_forward(video, QUERY_POINTS)
    out = _port_tracker(proj).track_points_forward(video, QUERY_POINTS)
    assert not out["visibilities"].any()
    np.testing.assert_array_equal(out["trajectories"][:2, 3], 0.0)
    np.testing.assert_allclose(out["trajectories"], ref["trajectories"], rtol=0,
                               atol=TRAJ_TOL_PX)


VOS_MODES = {
    "tiled": dict(attention_impl="tiled"),
    "tiled_save_mem": dict(attention_impl="tiled", save_mem=True),
    "c2f_save_mem": dict(attention_impl="c2f", save_mem=True),
}


@pytest.mark.parametrize("mode", list(VOS_MODES))
def test_track_masks_matches_jax(setup, mode):
    video, proj = setup
    ref = _jax_tracker(proj, **VOS_MODES[mode]).track_masks(video, _mask(), (H, W), 2)
    out = _port_tracker(proj, **VOS_MODES[mode]).track_masks(video, _mask(), (H, W), 2)
    assert out.shape == (T, H, W) and len(np.unique(out)) > 1
    np.testing.assert_array_equal(out, ref)


def test_tiled_row_blocks_equal_unsharded(setup):
    """Spatial-parallel 'tiled' at S = 2 CPU row blocks: trajectories and
    label maps (banked and save_mem) equal to the unsharded run's."""
    video, proj = setup
    whole, blocks = _port_tracker(proj, attention_impl="tiled"), \
        _port_tracker(proj, S=2, attention_impl="tiled")
    np.testing.assert_array_equal(blocks.track_points(video, QUERY_POINTS)["trajectories"],
                                  whole.track_points(video, QUERY_POINTS)["trajectories"])
    np.testing.assert_array_equal(blocks.track_masks(video, _mask(), (H, W), 2),
                                  whole.track_masks(video, _mask(), (H, W), 2))
    stream = _port_tracker(proj, S=2, attention_impl="tiled", save_mem=True)
    np.testing.assert_array_equal(
        stream.track_masks(video, _mask(), (H, W), 2),
        _port_tracker(proj, attention_impl="tiled", save_mem=True).track_masks(
            video, _mask(), (H, W), 2))


@pytest.mark.parametrize("bad,match,where", [
    (dict(attention_impl="c2f", input_size=(20, 20)), "divisible by c2f_scale", "both"),
    (dict(attention_impl="flow_guided", save_mem=True), "flow_guided", "both"),
    (dict(attention_impl="flow_guided", with_first_neighbor=False), "flow_guided", "both"),
    (dict(attention_impl="c2f"), "spatial-parallel propagation supports", "sp"),
    (dict(attention_impl="flow_guided"), "spatial-parallel propagation supports", "sp"),
])
def test_refusals_match_jax(setup, bad, match, where):
    """JAX's ValueErrors: c2f on a feature grid (10 x 10) that c2f_scale 4
    does not divide, flow_guided without a bank loop, and spatial-parallel
    propagation with another mode than 'pallas' and 'tiled'."""
    video, proj = setup
    if where == "sp":
        with pytest.raises(ValueError, match=match):
            _port_tracker(proj, S=2, **bad)
        return
    cfg = dict(SMALL, **bad)
    vid = video[:, :cfg["input_size"][0], :cfg["input_size"][1]]
    mask = _mask()[:vid.shape[1], :vid.shape[2]]
    for tracker in (_jax_tracker(proj, **{k: v for k, v in bad.items() if k != "input_size"}),
                    _port_tracker(proj, **{k: v for k, v in bad.items() if k != "input_size"})):
        with pytest.raises(ValueError, match=match):
            if bad.get("save_mem"):
                tracker.track_masks(vid, mask, vid.shape[1:3], 2)
            else:
                tracker.track_points(vid, QUERY_POINTS[:3])


# --------------------------------------------------------------------- #
# harness and CLI
# --------------------------------------------------------------------- #
RUN_SMALL = dict(input_size=(H, W), neighbor_range=8, tile=8, flow_radius=2)
MOVI_T = 8


@pytest.fixture(scope="module")
def movi(tmp_path_factory):
    """(data root with one MOVi scene at 32 x 32, reference .pth path)."""
    import jax

    from fgvc_tpu.models.resnet import init_resnet_params, resnet18_d1
    from fgvc_tpu.models.torch_convert import export_resnet_state_dict

    sys.path.insert(0, os.path.join(REPO, "tools", "data"))
    try:
        from generate_movi import generate_scene
    finally:
        sys.path.pop(0)
    root = tmp_path_factory.mktemp("movi")
    rec = generate_scene(np.random.default_rng(0), num_frames=MOVI_T, size=H, num_objects=2,
                         tracks_per_object=3, background_tracks=4)
    with open(root / "movi_00000.pkl", "wb") as f:
        pickle.dump(rec, f)
    variables = init_resnet_params(resnet18_d1(), jax.random.PRNGKey(0), (H, W))
    path = root / "weights.pth"
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in export_resnet_state_dict(variables).items()}}, path)
    return str(root), str(path)


@pytest.mark.parametrize("impl", ["tiled", "flow_guided"])
def test_run_task_davis_matches_jax(movi, impl):
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu.config import DAVIS_TEST_CFG as JAX_DAVIS_TEST_CFG
    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG

    root, pth = movi
    ref = jax_run_task("davis", root, checkpoint=pth, test_cfg=dataclasses.replace(
        JAX_DAVIS_TEST_CFG, **RUN_SMALL, frame_bucket=8, point_bucket=4, attention_impl=impl))
    out = run_task("davis", root, checkpoint=pth, device="cpu", test_cfg=dataclasses.replace(
        DAVIS_TEST_CFG, **RUN_SMALL, attention_impl=impl))
    shared = sorted(set(ref) & set(out))
    assert "average_pts_within_thresh" in shared and "average_jaccard" in shared
    for key in shared:
        assert np.isfinite(out[key]), key
        np.testing.assert_allclose(out[key], ref[key], rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=key)


def test_cli_runs_every_mode(movi, capsys):
    """python -m fgvc_tpu_torch.cli.test --task davis --attention-impl X
    [--topk-impl Y] --device cpu on the MOVi pickle: finite metrics."""
    from fgvc_tpu_torch.cli.test import main

    root, pth = movi
    for flags in (["--attention-impl", "tiled", "--topk-impl", "approx"],
                  ["--attention-impl", "dense"], ["--attention-impl", "c2f"],
                  ["--attention-impl", "flow_guided"]):
        main(["--task", "davis", "--data-root", root, "--checkpoint", pth, "--input-size",
              str(H), "--device", "cpu", "--output-dir", os.path.join(root, "out"), *flags])
        out = capsys.readouterr().out
        metrics = json.loads(out[out.index("\n{") + 1:])  # after the per-video lines
        assert np.isfinite(metrics["average_pts_within_thresh"]), flags


@pytest.mark.parametrize("flags,expect", [
    ([], ("pallas", "exact")),
    (["--attention-impl", "tiled", "--topk-impl", "certified"], ("tiled", "certified")),
    (["--attention-impl", "flow_guided"], ("flow_guided", "exact")),
])
def test_cli_flags_reach_test_config(flags, expect, monkeypatch, capsys):
    import fgvc_tpu_torch.apis.test as api
    from fgvc_tpu_torch.cli.test import main

    seen = {}
    monkeypatch.setattr(api, "run_task", lambda task, root, **kw: seen.update(kw) or {})
    for task in ("davis", "kinetics", "jhmdb", "badja", "vos"):
        main(["--task", task, "--data-root", REPO, "--device", "cpu", *flags])
        cfg = seen["test_cfg"]
        assert (cfg.attention_impl, cfg.topk_impl) == expect, task
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main(["--task", "davis", "--data-root", REPO, "--topk-impl", "fast"])
    capsys.readouterr()


def test_config_file_reads_the_new_fields(tmp_path, monkeypatch, capsys):
    """--config f.json sets the propagation fields fgvc_tpu's TestConfig
    has (JAX's defaults otherwise); an explicit flag wins over the file."""
    import fgvc_tpu_torch.apis.test as api
    from fgvc_tpu.config import TestConfig as JaxTestConfig
    from fgvc_tpu_torch.cli.test import main
    from fgvc_tpu_torch.config import TestConfig

    fields = ("topk_impl", "c2f_scale", "radius_fine", "c2f_step", "flow_radius", "flow_step")
    assert {f: getattr(TestConfig(), f) for f in fields} == \
        {f: getattr(JaxTestConfig(), f) for f in fields}
    new = dict(attention_impl="c2f", topk_impl="segmented", c2f_scale=2, radius_fine=5,
               c2f_step=64, flow_radius=3, flow_step=128)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(new))
    seen = {}
    monkeypatch.setattr(api, "run_task", lambda task, root, **kw: seen.update(kw) or {})
    main(["--task", "vos", "--data-root", REPO, "--device", "cpu", "--config", str(path),
          "--attention-impl", "tiled"])
    capsys.readouterr()
    assert {f: getattr(seen["test_cfg"], f) for f in new} == dict(new, attention_impl="tiled")
