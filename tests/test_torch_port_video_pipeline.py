"""The port's video-input path against the JAX package's, on the CPU, over
VP8 WebM clips that cv2.VideoWriter writes here (the JAX side decodes them
with cv2.VideoCapture, the port with its own reader): the clip samplers on
the same seeds, VideoInit / VideoDecode / decode_video / RawFrameDecode,
TapVidKineticsVideoDataset (samples, load_raw, __getitem__) equal;
``run_task('kinetics', annotations=CSV)`` within 1e-6 of the JAX harness
with the same ResNet-18-d1 weights (the reference .pth both read), and
exactly equal to the port's own run over per-video pickles of the same
decode, also with query_mode 'strided' and two CPU copies; the demo's
load_video equal and its --video run; cv2's MPEG-4 Part 2 and VP9 clips
and the port's own Motion-JPEG clip, once refused there, read through the
reader, the dataset and the demo.
"""

import csv
import dataclasses
import os
import pickle
import re

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data
import test_torch_port_video_codec as codec

cv2 = pytest.importorskip("cv2")

H = W = 32
SMALL = dict(neighbor_range=8, tile=8, input_size=(H, W))
METRIC_TOL = 1e-6
T = 13


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_csv(path, video_ids, seed=0, n_points=5):
    """TAP-Vid-Kinetics CSV rows: points drifting across the frame, each
    occluded for a few frames and one hidden until frame 4; one id without
    a clip."""
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["video_id", "point_id", "frame", "x", "y", "occluded"])
        for vid in video_ids:
            for pid in range(n_points):
                p0, v = rng.uniform(0.15, 0.85, 2), rng.uniform(-0.02, 0.02, 2)
                hidden = set(rng.choice(T, 2, replace=False).tolist())
                for t in range(T + 2):  # two rows past the clip's end drop
                    x, y = np.clip(p0 + v * t, 0.0, 1.0)
                    occ = int(t in hidden or (pid == 0 and t < 4))
                    out.writerow([vid, pid, t, f"{x:.6f}", f"{y:.6f}", occ])
        out.writerow(["clip_gone", 0, 0, 0.5, 0.5, 0])
    return str(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from fgvc_tpu_torch.utils.visualize import save_video

    base = tmp_path_factory.mktemp("video_pipeline")
    clips = base / "clips"
    clips.mkdir()
    for i, vid in enumerate(("clip_a", "clip_b")):
        codec.write_clip(clips / f"{vid}.webm", codec.clip_frames(48, 40, T, seed=20 + i))
    frames = base / "frames"
    frames.mkdir()
    for i, f in enumerate(codec.clip_frames(40, 24, 4, seed=9)):
        cv2.imwrite(str(frames / f"img_{i:05}.jpg"), f)
    refused = base / "refused"
    refused.mkdir()
    codec.write_clip(refused / "clip_a.mp4", codec.clip_frames(48, 40, 4, seed=1), "mp4v")
    codec.write_clip(refused / "clip_b.webm", codec.clip_frames(48, 40, 4, seed=2), "VP90")
    save_video(codec.clip_frames(48, 40, 4, seed=3)[..., ::-1], str(refused / "clip_c.mp4"))
    return {"clips": str(clips), "clip": str(clips / "clip_a.webm"), "frames": str(frames),
            "csv": write_csv(base / "ann.csv", ("clip_a", "clip_b")),
            "refused": str(refused),
            "refused_csv": write_csv(base / "ref.csv", ("clip_a", "clip_b", "clip_c")),
            "pth": data.export_pth(base / "weights.pth", (H, W)), "base": base}


SAMPLERS = {
    "train": ("SampleFrames", dict(clip_len=4, frame_interval=2, num_clips=3)),
    "test-twice": ("SampleFrames", dict(clip_len=4, frame_interval=2, num_clips=3,
                                        test_mode=True, twice_sample=True)),
    "jitter": ("SampleFrames", dict(clip_len=8, frame_interval=3, temporal_jitter=True)),
    "repeat-last": ("SampleFrames", dict(clip_len=16, frame_interval=4, num_clips=2,
                                         out_of_bound_opt="repeat_last")),
    "keep-tail": ("SampleFrames", dict(clip_len=4, frame_interval=2, num_clips=3,
                                       keep_tail_frames=True)),
    "untrimmed": ("UntrimmedSampleFrames", dict(clip_len=3, frame_interval=5)),
    "dense-train": ("DenseSampleFrames", dict(clip_len=2, num_clips=4, sample_range=16,
                                              num_sample_positions=3)),
    "dense-test": ("DenseSampleFrames", dict(clip_len=2, num_clips=4, sample_range=16,
                                             num_sample_positions=3, test_mode=True)),
}


@pytest.mark.parametrize("total", [3, 13, 66, 251])
@pytest.mark.parametrize("case", sorted(SAMPLERS))
def test_samplers_equal_jax(case, total):
    """Three draws in a row from each sampler, the same seed: equal."""
    import fgvc_tpu.datasets.video_decode as jax_vd
    import fgvc_tpu_torch.datasets.video_decode as vd

    name, kw = SAMPLERS[case]
    if name != "UntrimmedSampleFrames":
        kw = dict(kw, seed=5)
    ours, ref = getattr(vd, name)(**kw), getattr(jax_vd, name)(**kw)
    for _ in range(3):
        a = ours({"total_frames": total, "start_index": 1})
        b = ref({"total_frames": total, "start_index": 1})
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "imgs":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert x.dtype == y.dtype == np.uint8
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_init_and_decode_equal_jax(tree):
    """VideoInit's count, VideoDecode of picked indices (two past the end
    repeat the last frame) and its 'error' mode, decode_video with and
    without a resize, as the JAX stages give them through cv2."""
    import fgvc_tpu.datasets.video_decode as jax_vd
    import fgvc_tpu_torch.datasets.video_decode as vd

    a = vd.VideoInit()({"filename": tree["clip"]})
    b = jax_vd.VideoInit()({"filename": tree["clip"]})
    assert a == b and a["total_frames"] == T
    inds = np.array([0, 3, 3, 12, 7, T, T + 1])
    a = vd.VideoDecode()({"filename": tree["clip"], "frame_inds": inds})
    b = jax_vd.VideoDecode()({"filename": tree["clip"], "frame_inds": inds})
    _assert_same(a, b)
    np.testing.assert_array_equal(a["imgs"][-1], a["imgs"][3])
    for mod in (vd, jax_vd):
        with pytest.raises(IOError, match="failed to decode frames"):
            mod.VideoDecode("error")({"filename": tree["clip"], "frame_inds": inds})
    for resize in (None, (24, 20), (64, 50)):
        got = vd.decode_video(tree["clip"], resize=resize)
        np.testing.assert_array_equal(got, jax_vd.decode_video(tree["clip"], resize=resize))
    assert got.shape == (T, 50, 64, 3)
    for alias in ("DecordInit", "OpenCVInit", "DecordDecode", "OpenCVDecode"):
        assert getattr(vd, alias).__name__ == getattr(jax_vd, alias).__name__


def test_raw_frame_decode_equal_jax(tree):
    import fgvc_tpu.datasets.video_decode as jax_vd
    import fgvc_tpu_torch.datasets.video_decode as vd

    res = {"frame_dir": tree["frames"], "frame_inds": np.array([3, 0, 2])}
    _assert_same(vd.RawFrameDecode()(dict(res)), jax_vd.RawFrameDecode()(dict(res)))
    for mod in (vd, jax_vd):
        with pytest.raises(IOError, match="cannot read frame"):
            mod.RawFrameDecode()({"frame_dir": tree["frames"], "frame_inds": [7]})


@pytest.mark.parametrize("query_mode", ["first", "strided"])
def test_kinetics_dataset_equal_jax(tree, query_mode):
    from fgvc_tpu.datasets.tapvid_kinetics import TapVidKineticsVideoDataset as JaxDs
    from fgvc_tpu_torch.datasets.tapvid_kinetics import TapVidKineticsVideoDataset

    ours = TapVidKineticsVideoDataset(tree["clips"], tree["csv"], query_mode=query_mode,
                                      input_size=(H, W))
    ref = JaxDs(tree["clips"], tree["csv"], query_mode=query_mode, input_size=(H, W))
    assert len(ours) == len(ref) == 2 and ours.missing_clips == ref.missing_clips == 1
    assert [s[:2] for s in ours.samples] == [s[:2] for s in ref.samples]
    for i in range(len(ours)):
        for a, b in ((ours.load_raw(i), ref.load_raw(i)), (ours[i], ref[i])):
            assert a.keys() == b.keys()
            for k in a:
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _port_cfg():
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS

    return dataclasses.replace(TASK_CONFIGS["kinetics"], **SMALL)


@pytest.mark.parametrize("query_mode", ["first", "strided"])
def test_run_task_annotations_matches_jax(tree, query_mode):
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import run_task

    jax_cfg = dataclasses.replace(JAX_TASK_CONFIGS["kinetics"], **SMALL, frame_bucket=8,
                                  point_bucket=4, attention_impl="pallas")
    ref = jax_run_task("kinetics", tree["clips"], checkpoint=tree["pth"], test_cfg=jax_cfg,
                       query_mode=query_mode, annotations=tree["csv"])
    out = run_task("kinetics", tree["clips"], checkpoint=tree["pth"], test_cfg=_port_cfg(),
                   device="cpu", query_mode=query_mode, annotations=tree["csv"])
    shared = sorted(set(ref) & set(out))
    assert "average_pts_within_thresh" in shared and "average_jaccard" in shared
    for k in shared:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=METRIC_TOL, atol=METRIC_TOL, err_msg=k)


def test_run_task_annotations_equals_pickles(tree):
    """The CSV + clips run gives the metrics of a run over per-video
    pickles holding the same decoded frames and tracks, exactly; with
    query_mode 'strided' and with two CPU copies (local_devices) too."""
    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.datasets.tapvid_kinetics import TapVidKineticsVideoDataset

    root = tree["base"] / "pickles"
    root.mkdir(exist_ok=True)
    ds = TapVidKineticsVideoDataset(tree["clips"], tree["csv"], input_size=(H, W))
    for i, (vid, _, _) in enumerate(ds.samples):
        with open(root / f"{vid}.pkl", "wb") as f:
            pickle.dump(ds.load_raw(i), f)
    kw = dict(checkpoint=tree["pth"], test_cfg=_port_cfg(), device="cpu")
    for extra in ({}, {"query_mode": "strided"}, {"local_devices": 2}):
        assert (run_task("kinetics", tree["clips"], annotations=tree["csv"], **kw, **extra)
                == run_task("kinetics", str(root), **kw, **extra)), extra


def test_annotations_refused_for_other_tasks(tree):
    from fgvc_tpu_torch.apis.test import run_task

    with pytest.raises(ValueError, match="kinetics"):
        run_task("davis", tree["clips"], annotations=tree["csv"], device="cpu")


def test_demo_load_video_equal_jax(tree):
    from fgvc_tpu.cli.demo import load_video as jax_load_video
    from fgvc_tpu_torch.cli.demo import load_video

    for stride, max_frames in ((1, 0), (2, 3), (5, 0)):
        got = load_video(tree["clip"], 32, stride=stride, max_frames=max_frames)
        np.testing.assert_array_equal(
            got, jax_load_video(tree["clip"], 32, stride=stride, max_frames=max_frames))
    assert got.shape == (3, 32, 32, 3)


def test_demo_video_cli(tree):
    from fgvc_tpu_torch.cli.demo import main
    from fgvc_tpu_torch.utils.visualize import read_video

    out = str(tree["base"] / "demo.mp4")
    main(["--video", tree["clip"], "--stride", "2", "--max-frames", "3", "--grid", "2",
          "--size", "32", "--out", out, "--device", "cpu"])
    frames, fps = read_video(out)
    assert frames.shape == (3, 32, 32, 3)


@pytest.mark.parametrize("clip,match", [("clip_a.mp4", r"mp4v \(MPEG-4 Part 2\)"),
                                        ("clip_b.webm", "V_VP9"), ("clip_c.mp4", r"mp4v \(JPEG\)")])
def test_refused_clips_name_their_codec(tree, clip, match):
    """cv2's MPEG-4 Part 2 and VP9 clips and the port's own Motion-JPEG
    .mp4, refused by those names until the port had decoders for them, now
    go through the dataset, decode_video and the demo as the JAX package's
    cv2 path reads them (a clip the port still refuses stops all three with
    its path and codec: tests/test_torch_port_video_avi_mjpeg.py)."""
    from fgvc_tpu.datasets.tapvid_kinetics import TapVidKineticsVideoDataset as JaxDs
    from fgvc_tpu.datasets.video_decode import decode_video as jax_decode_video
    from fgvc_tpu_torch.cli.demo import main
    from fgvc_tpu_torch.data_io.video import VideoReader
    from fgvc_tpu_torch.datasets.tapvid_kinetics import TapVidKineticsVideoDataset
    from fgvc_tpu_torch.datasets.video_decode import VideoInit, decode_video

    path = os.path.join(tree["refused"], clip)
    ds = TapVidKineticsVideoDataset(tree["refused"], tree["refused_csv"], input_size=(H, W))
    assert len(ds) == 3
    idx = [s[1] for s in ds.samples].index(path)
    demo = ["--video", path, "--grid", "2", "--size", "32", "--out",
            str(tree["base"] / f"{clip}.demo.mp4"), "--device", "cpu"]
    with VideoReader(path) as reader:
        assert re.fullmatch(match, reader.codec)
    ref = JaxDs(tree["refused"], tree["refused_csv"], input_size=(H, W))
    _assert_same(ds[idx], ref[[s[1] for s in ref.samples].index(path)])
    np.testing.assert_array_equal(decode_video(path), jax_decode_video(path))
    assert VideoInit()({"filename": path})["total_frames"] == 4
    main(demo)
    assert os.path.getsize(demo[-3]) > 0
