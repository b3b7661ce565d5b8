"""The port's VP9 decoder (fgvc_tpu_torch/csrc/vp9video.cpp behind the WebM
demuxer and swscale's YUV -> BGR of csrc/fgpack.cpp) against
cv2.VideoCapture on clips that cv2.VideoWriter writes here with libvpx
('VP90', in .webm and .mkv): packets byte for byte (CAP_PROP_FORMAT = -1),
the luma plane against cv2's CAP_PROP_CONVERT_RGB = 0 plane, every BGR frame
bit for bit, the frame count and rate at several rates; the committed
640 x 360 fixture against its digests; the Kinetics path over VP9 clips
(TapVidKineticsVideoDataset and decode_video equal, ``run_task('kinetics',
annotations=CSV)`` within 1e-6 of the JAX harness reading the same files
through cv2).  libvpx's tools that cv2's writer leaves out are held to
libvpx's own decoder in tests/test_torch_port_video_vp9_libvpx.py.

    python tests/test_torch_port_video_vp9.py   # remakes the fixture and its JSON
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import test_torch_port_video_codec as codec

cv2 = pytest.importorskip("cv2")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_port_fixtures", "vp9_640x360_250f.webm")
FIXTURE_JSON = os.path.join(HERE, "torch_port_fixtures", "vp9_640x360_250f.json")
# name -> (width, height, frames): sizes that are not multiples of 8 or 64,
# in both containers cv2's writer makes
CLIPS = {"96x64.webm": (96, 64, 30), "100x60.mkv": (100, 60, 26), "34x18.webm": (34, 18, 14),
         "130x94.mkv": (130, 94, 25), "250x142.webm": (250, 142, 30)}
H = W = 32
T = 13


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    base = tmp_path_factory.mktemp("vp9")
    return {name: codec.write_clip(base / name, codec.clip_frames(w, h, n, seed=w), "VP90")
            for name, (w, h, n) in CLIPS.items()}


@pytest.mark.parametrize("name", ["96x64.webm", "130x94.mkv"])
def test_packets_equal_cv2(clips, name):
    from fgvc_tpu_torch.data_io.video import VideoReader

    ref, _ = codec.cv2_read(clips[name], raw=True)
    with VideoReader(clips[name]) as reader:
        assert reader.codec == "V_VP9"
        assert (reader.width, reader.height) == CLIPS[name][:2]
        assert reader.packets() == ref
        assert reader.keys[0] == 1


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_frames_equal_cv2(clips, name):
    """Every frame as cv2.VideoCapture.read gives it, bit for bit, the same
    number of them, and CAP_PROP_FRAME_COUNT / CAP_PROP_FPS."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    ref, (count, fps) = codec.cv2_read(clips[name])
    with VideoReader(clips[name]) as reader:
        got = list(reader)
        assert (reader.frame_count, reader.fps) == (count, fps)
        used = reader.features()
    assert len(got) == len(ref) == CLIPS[name][2]
    for t, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.array_equal(a, b), (name, t, int(np.abs(a.astype(int) - b).max()))
    # cv2's writer: libvpx's good-quality defaults (key frames, inter
    # frames, switchable filters, frame-parallel mode, tx-size selection)
    assert used["key_frames"] >= 1 and used["inter_frames"] > 0
    assert used["switchable_frames"] > 0 and used["frame_parallel_frames"] > 0


@pytest.mark.parametrize("name", ["96x64.webm", "34x18.webm"])
def test_luma_equals_cv2_grey_plane(clips, name):
    """With CAP_PROP_CONVERT_RGB = 0 cv2 returns the decoded frame's first
    plane, the decoder's Y."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    ref, _ = codec.cv2_read(clips[name], convert_rgb=False)
    with VideoReader(clips[name]) as reader:
        for t, grey in enumerate(ref):
            assert reader.read() is not None
            y, u, v = reader.planes()
            w, h = CLIPS[name][:2]
            assert u.shape == v.shape == ((h + 1) // 2, (w + 1) // 2)
            assert np.array_equal(y, grey.reshape(y.shape)), (name, t)
        assert reader.read() is None


@pytest.mark.parametrize("fps", [10.0, 24.0, 30000 / 1001, 50.0])
def test_rate_and_count_equal_cv2(tmp_path, fps):
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = codec.write_clip(tmp_path / "r.webm", codec.clip_frames(48, 32, 12, seed=1), "VP90",
                            fps=fps)
    ref, meta = codec.cv2_read(path)
    with VideoReader(path) as reader:
        assert (reader.frame_count, reader.fps) == meta
        assert all(np.array_equal(a, b) for a, b in zip(reader, ref))


# ---- the committed fixture --------------------------------------------------

def test_fixture_json_is_cv2s():
    with open(FIXTURE_JSON) as f:
        pinned = json.load(f)
    assert os.path.getsize(FIXTURE) <= 1_500_000
    assert codec.fixture_record(FIXTURE) == pinned
    assert (pinned["width"], pinned["height"], pinned["frames"]) == (640, 360, 250)


def test_fixture_decodes_to_pinned_digests():
    from fgvc_tpu_torch.data_io.video import VideoReader

    with open(FIXTURE_JSON) as f:
        pinned = json.load(f)
    with VideoReader(FIXTURE) as reader:
        assert reader.codec == "V_VP9"
        digests = [hashlib.sha256(f.tobytes()).hexdigest() for f in reader]
        assert (reader.frame_count, reader.fps) == (pinned["cv2_frame_count"], pinned["cv2_fps"])
        used = reader.features()
    assert digests == pinned["sha256"]
    assert used["multi_tile_frames"] == 250 and used["key_frames"] > 1


# ---- the Kinetics path over VP9 clips -----------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import test_torch_port_eval_data as data
    import test_torch_port_video_pipeline as pipeline

    base = tmp_path_factory.mktemp("vp9_pipeline")
    clip_dir = base / "clips"
    clip_dir.mkdir()
    for i, vid in enumerate(("clip_a", "clip_b")):
        codec.write_clip(clip_dir / f"{vid}.webm", codec.clip_frames(48, 40, T, seed=30 + i),
                         "VP90")
    return {"clips": str(clip_dir), "clip": str(clip_dir / "clip_a.webm"),
            "csv": pipeline.write_csv(base / "ann.csv", ("clip_a", "clip_b")),
            "pth": data.export_pth(base / "weights.pth", (H, W))}


def test_dataset_and_decode_video_equal_jax(tree):
    """TapVidKineticsVideoDataset (samples, load_raw, __getitem__),
    VideoInit and decode_video over VP9 clips as the JAX package's cv2 path
    gives them."""
    import fgvc_tpu.datasets.video_decode as jax_vd
    import fgvc_tpu_torch.datasets.video_decode as vd
    from fgvc_tpu.datasets.tapvid_kinetics import TapVidKineticsVideoDataset as JaxDs
    from fgvc_tpu_torch.datasets.tapvid_kinetics import TapVidKineticsVideoDataset

    ours = TapVidKineticsVideoDataset(tree["clips"], tree["csv"], input_size=(H, W))
    ref = JaxDs(tree["clips"], tree["csv"], input_size=(H, W))
    assert len(ours) == len(ref) == 2
    for i in range(len(ours)):
        for a, b in ((ours.load_raw(i), ref.load_raw(i)), (ours[i], ref[i])):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    clip = {"filename": tree["clip"]}
    assert vd.VideoInit()(dict(clip)) == jax_vd.VideoInit()(dict(clip))
    for resize in (None, (24, 20)):
        np.testing.assert_array_equal(vd.decode_video(tree["clip"], resize=resize),
                                      jax_vd.decode_video(tree["clip"], resize=resize))


def test_run_task_annotations_matches_jax(tree):
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import run_task

    import test_torch_port_video_pipeline as pipeline

    jax_cfg = dataclasses.replace(JAX_TASK_CONFIGS["kinetics"], **pipeline.SMALL, frame_bucket=8,
                                  point_bucket=4, attention_impl="pallas")
    ref = jax_run_task("kinetics", tree["clips"], checkpoint=tree["pth"], test_cfg=jax_cfg,
                       annotations=tree["csv"])
    out = run_task("kinetics", tree["clips"], checkpoint=tree["pth"], test_cfg=pipeline._port_cfg(),
                   device="cpu", annotations=tree["csv"])
    shared = sorted(set(ref) & set(out))
    assert "average_pts_within_thresh" in shared and "average_jaccard" in shared
    for k in shared:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=pipeline.METRIC_TOL,
                                   atol=pipeline.METRIC_TOL, err_msg=k)


if __name__ == "__main__":
    codec.write_clip(FIXTURE, codec.fixture_frames()[..., ::-1], "VP90")
    with open(FIXTURE_JSON, "w") as f:
        json.dump(codec.fixture_record(FIXTURE), f, indent=1)
    print(FIXTURE, os.path.getsize(FIXTURE), "bytes")
