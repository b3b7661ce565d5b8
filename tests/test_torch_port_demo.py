"""The port's demo CLI and renderer (fgvc_tpu_torch/cli/demo.py,
utils/visualize.py) against the JAX package's (fgvc_tpu/cli/demo.py,
fgvc_tpu/utils/visualize.py, which draws with cv2), on the CPU:

* every drawing function on random tracks, points off the image, on its
  borders and on .5 coordinates included: pixels equal to cv2's;
* non_local_attention with each of its arguments against JAX's, within
  float32's rounding of the two products, the argmax equal;
* the demo on a frame directory of JPEG and PNG files (64 x 64, the same
  exported ResNet-18-d1 .pth, small windows in both packages): trajectory
  mode (tracks within 1e-3 px, the rendered frames equal wherever no
  coordinate lies within 1e-3 px of a rounding boundary), --correspondence
  (the 64 matches equal except rows whose top two softmax values lie within
  1e-6 relative; the .png decodes to the overlay), --mask (the overlays
  equal);
* the .mp4 read back by cv2.VideoCapture (frame count, size, fps, each
  frame at PSNR >= 35 dB against the rendered frame) and by the port's own
  reader (samples byte-equal to encode_jpeg of the rendered frames at
  4:4:4, which equals cv2.imencode's);
* other extensions than .gif and .mp4 (.GIF among them: the JAX writer's
  test is case-sensitive) raise, and --video raises its message.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

SIZE, T = 64, 6
SMALL = dict(neighbor_range=8, tile=8)
TRACK_TOL = 1e-3
TIE_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------- #
# drawing
# ---------------------------------------------------------------------- #
def _random_tracks(rng, P, T_, h, w):
    tracks = rng.uniform(-6, [w + 6, h + 6], (P, T_, 2))
    tracks[0, :, 0] = np.arange(T_) + 0.5           # .5 centres: half to even
    tracks[1, :, 1] = np.arange(T_) * 2.5
    tracks[2] = [0.0, h - 1.0]                       # on the borders
    tracks[3] = [w - 1.0, 0.0]
    tracks[4, ::2] = [-0.25, 3.0]                    # negative: skipped
    return tracks.astype(np.float32)


def test_drawing_equals_cv2():
    import fgvc_tpu.utils.visualize as jv
    from fgvc_tpu_torch.utils import visualize as v

    rng = np.random.default_rng(0)
    for h, w, P in ((24, 40, 7), (9, 5, 6), (64, 64, 12)):
        frames = rng.integers(0, 256, (T, h, w, 3), dtype=np.uint8)
        tracks = _random_tracks(rng, P, T, h, w)
        vis = rng.random((P, T)) > 0.3
        np.testing.assert_array_equal(v.point_colors(P), jv.point_colors(P))
        for radius in (2, 3):
            np.testing.assert_array_equal(v.paint_point_track(frames, tracks, radius=radius),
                                          jv.paint_point_track(frames, tracks, radius=radius))
        np.testing.assert_array_equal(v.paint_point_track(frames, tracks, vis),
                                      jv.paint_point_track(frames, tracks, vis))
        for tail in (8, 2):
            np.testing.assert_array_equal(v.draw_trajectory_tails(frames, tracks, tail),
                                          jv.draw_trajectory_tails(frames, tracks, tail))
        other = rng.integers(0, 256, (h + 3, w - 2, 3), dtype=np.uint8)
        matches = np.concatenate([tracks[:, 0], tracks[:, 1]], -1).clip(0, None)
        np.testing.assert_array_equal(v.correspondence_overlay(frames[0], other, matches),
                                      jv.correspondence_overlay(frames[0], other, matches))
        masks = rng.integers(0, 4, (T, h, w))
        np.testing.assert_array_equal(v.mask_overlay(frames, masks),
                                      jv.mask_overlay(frames, masks))
    # long lines across and beyond the image, as cv2.clipLine cuts them
    img = np.zeros((30, 50, 3), np.uint8)
    for _ in range(300):
        p1, p2 = (tuple(int(c) for c in rng.integers(-400, 400, 2)) for _ in range(2))
        ref = img.copy()
        cv2.line(ref, p1, p2, (9, 8, 7), 1)
        got = img.copy()
        v.draw_line(got, p1, p2, (9, 8, 7))
        np.testing.assert_array_equal(got, ref, err_msg=f"{p1} {p2}")


@pytest.mark.parametrize("normalize,axis", [(True, -1), (False, -1), (True, 0)])
def test_non_local_attention_matches_jax(normalize, axis):
    """ops/attention.py non_local_attention against fgvc_tpu's on the same
    features: one key frame and three, the demo's temperature and the
    propagation's.  Both products are float32 sums of C terms in their own
    order, so each logit may move by 2 C eps |q| |k| / t and each
    probability by twice that, relative (no more: the row's largest
    logits move together)."""
    import jax.numpy as jnp

    from fgvc_tpu.ops.attention import non_local_attention as jax_nla
    from fgvc_tpu_torch.ops.attention import non_local_attention

    rng = np.random.default_rng(4)
    q = rng.standard_normal((6, 7, 16)).astype(np.float32)
    for key in (rng.standard_normal((6, 7, 16)), rng.standard_normal((3, 6, 7, 16))):
        key = key.astype(np.float32)
        for t in (0.001, 0.07):
            kw = dict(temperature=t, normalize=normalize, softmax_axis=axis)
            want = np.asarray(jax_nla(jnp.asarray(q), jnp.asarray(key), **kw))
            got = non_local_attention(torch.from_numpy(q), torch.from_numpy(key), **kw).numpy()
            assert got.shape == want.shape == (42, key.size // 16)
            norms = 1.0 if normalize else (np.linalg.norm(q, axis=-1).max()
                                           * np.linalg.norm(key, axis=-1).max())
            logit_tol = 2 * 16 * np.finfo(np.float32).eps * norms / t
            assert np.all(np.abs(got - want) <= 2 * logit_tol * want + 1e-12), (t, key.shape)
            np.testing.assert_array_equal(got.argmax(axis), want.argmax(axis))


# ---------------------------------------------------------------------- #
# the demo, both packages
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    base = tmp_path_factory.mktemp("demo")
    video, _ = data.panning_video(np.random.default_rng(3), T, 48, 72)
    frames = base / "frames"
    frames.mkdir()
    for t, f in enumerate(video):
        if t % 2:
            Image.fromarray(f).save(frames / f"f{t:03d}.png")
        else:
            Image.fromarray(f).save(frames / f"f{t:03d}.jpg", quality=90)
    labels = np.zeros((SIZE, SIZE), np.uint8)
    labels[10:30, 8:40], labels[36:60, 30:58] = 1, 2
    Image.fromarray(labels, "L").save(base / "mask.png")
    return dict(base=base, frames=str(frames), mask=str(base / "mask.png"),
                pth=data.export_pth(base / "w.pth", (SIZE, SIZE)))


@pytest.fixture(scope="module")
def both(scene):
    """Runs each package's demo with argv; the frames handed to save_video,
    the tracks handed to paint_point_track and the matches handed to
    correspondence_overlay are captured, and the port's files written."""
    import jax

    import fgvc_tpu.apis.test as jax_harness
    import fgvc_tpu.utils.visualize as jv
    import fgvc_tpu_torch.apis.test as harness
    from fgvc_tpu_torch.utils import visualize as v

    mp = pytest.MonkeyPatch()
    mp.setitem(jax_harness.TASK_CONFIGS, "davis", dataclasses.replace(
        jax_harness.TASK_CONFIGS["davis"], **SMALL, frame_bucket=8, point_bucket=16))
    mp.setitem(harness.TASK_CONFIGS, "davis",
               dataclasses.replace(harness.TASK_CONFIGS["davis"], **SMALL))
    seen = {}
    for side, mod, write in (("jax", jv, False), ("port", v, True)):
        for name in ("save_video", "paint_point_track", "correspondence_overlay"):
            def spy(*a, _orig=getattr(mod, name), _key=(side, name), _write=write, **kw):
                seen[_key] = a if _key[1] != "save_video" else a[0]
                if _key[1] == "save_video" and not _write:
                    return None
                return _orig(*a, **kw)

            mp.setattr(mod, name, spy)
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)

    def run(side, *argv):
        from fgvc_tpu.cli.demo import main as jax_main
        from fgvc_tpu_torch.cli.demo import main

        seen.clear()
        args = ["--frames", scene["frames"], "--size", str(SIZE), "--checkpoint", scene["pth"],
                *argv]
        if side == "jax":
            mp.setattr("sys.argv", ["demo", *args, "--platform", "cpu"])
            jax_main()
        else:
            main([*args, "--device", "cpu"])
        return dict(seen)

    yield run
    jax.config.update("jax_compilation_cache_dir", cache[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", cache[1])
    mp.undo()


def _near_boundary(x):
    """Coordinates within TRACK_TOL of a rounding (.5) or truncation (.0)
    boundary."""
    frac = np.abs(x - np.floor(x))
    return (np.abs(frac - 0.5) < TRACK_TOL) | (frac < TRACK_TOL) | (frac > 1 - TRACK_TOL)


def test_trajectory_demo_matches_jax_and_its_mp4_reads_back(scene, both):
    from fgvc_tpu_torch.data_io.fgpack import encode_jpeg
    from fgvc_tpu_torch.utils import visualize as v

    out = str(scene["base"] / "tracks.mp4")
    ref = both("jax", "--grid", "3", "--out", str(scene["base"] / "jax.mp4"))
    got = both("port", "--grid", "3", "--out", out)
    _, jt = ref[("jax", "paint_point_track")]
    _, pt = got[("port", "paint_point_track")]
    assert pt.shape == jt.shape == (9, T, 2)
    np.testing.assert_allclose(pt, jt, atol=TRACK_TOL, rtol=0)
    frames_ref, frames = ref[("jax", "save_video")], got[("port", "save_video")]
    video = got[("port", "paint_point_track")][0]
    # the port's drawing on the JAX tracks gives the JAX frames exactly
    np.testing.assert_array_equal(
        v.draw_trajectory_tails(v.paint_point_track(video, jt), jt), frames_ref)
    differ = (np.round(pt) != np.round(jt)) | (np.trunc(pt) != np.trunc(jt))
    assert _near_boundary(jt[differ]).all()
    if not differ.any():
        np.testing.assert_array_equal(frames, frames_ref)

    cap = cv2.VideoCapture(out)
    assert cap.isOpened()
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == T
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (SIZE, SIZE)
    assert cap.get(cv2.CAP_PROP_FPS) == 24
    for t in range(T):
        ok, bgr = cap.read()
        assert ok, t
        mse = np.mean((bgr[..., ::-1].astype(np.float64) - frames[t]) ** 2)
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 35.0, t
    assert not cap.read()[0]
    cap.release()
    mp4 = v.read_mp4(out)
    assert (mp4.width, mp4.height, mp4.fps) == (SIZE, SIZE, 24)
    assert mp4.samples == [encode_jpeg(f, 95, sampling="444") for f in frames]
    back, fps = v.read_video(out)
    assert back.shape == frames.shape and fps == 24


def test_correspondence_demo_matches_jax(scene, both):
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, build_tracker
    from fgvc_tpu_torch.cli.demo import load_frames
    from fgvc_tpu_torch.datasets.image_io import read_image
    from fgvc_tpu_torch.ops.attention import non_local_attention

    out = str(scene["base"] / "corr.png")
    ref = both("jax", "--correspondence", "--out", str(scene["base"] / "jax_corr.png"))
    got = both("port", "--correspondence", "--out", out)
    a, b, matches_ref = ref[("jax", "correspondence_overlay")]
    pa, pb, matches = got[("port", "correspondence_overlay")]
    np.testing.assert_array_equal(pa, a)
    np.testing.assert_array_equal(pb, b)
    assert matches.shape == matches_ref.shape == (64, 4)
    np.testing.assert_array_equal(matches[:, :2], matches_ref[:, :2])
    rows = np.nonzero((matches != matches_ref).any(-1))[0]
    if len(rows):
        video = load_frames(scene["frames"], SIZE)
        cfg = dataclasses.replace(TASK_CONFIGS["davis"], input_size=(SIZE, SIZE))
        feats = build_tracker(cfg, scene["pth"], device="cpu").extract_features(video[:2])
        w, stride = feats.shape[2], SIZE // feats.shape[2]
        aff = non_local_attention(feats[0], feats[1], temperature=0.001).numpy()
        for r in rows:
            x, y = matches[r, :2] // stride
            top = np.sort(aff[int(y) * w + int(x)])[-2:]
            assert top[1] - top[0] <= TIE_RTOL * top[1], (r, top)
    assert len(rows) <= 2
    from fgvc_tpu_torch.utils.visualize import correspondence_overlay

    np.testing.assert_array_equal(read_image(out), correspondence_overlay(pa, pb, matches))
    if not len(rows):
        np.testing.assert_array_equal(read_image(out), read_image(str(scene["base"] /
                                                                     "jax_corr.png")))


def test_mask_demo_matches_jax(scene, both):
    out = str(scene["base"] / "masks.mp4")
    ref = both("jax", "--mask", scene["mask"], "--out", str(scene["base"] / "jax_masks.mp4"))
    got = both("port", "--mask", scene["mask"], "--out", out)
    np.testing.assert_array_equal(got[("port", "save_video")], ref[("jax", "save_video")])
    assert os.path.getsize(out) > 0


def test_refusals(scene, tmp_path):
    from fgvc_tpu_torch.cli.demo import VIDEO_REFUSAL, main
    from fgvc_tpu_torch.utils import visualize as v

    frames = np.zeros((2, 16, 16, 3), np.uint8)
    for name in ("x.GIF", "x.avi", "x.webm"):
        with pytest.raises(ValueError, match=r"\.mp4"):
            v.save_video(frames, str(tmp_path / name))
    with pytest.raises(ValueError, match="T >= 1"):
        v.save_video(frames[:0], str(tmp_path / "empty.mp4"))
    with pytest.raises(ValueError, match="png or .jpg"):
        v.save_image(frames[0], str(tmp_path / "x.bmp"))
    img = np.random.default_rng(1).integers(0, 256, (21, 35, 3), dtype=np.uint8)
    v.save_image(img, str(tmp_path / "x.jpg"))
    assert open(tmp_path / "x.jpg", "rb").read() == cv2.imencode(".jpg", img[..., ::-1])[1].tobytes()
    # the video's samples: cv2.imencode's 4:4:4 bytes
    params = [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    v.save_video(img[None], str(tmp_path / "x.mp4"))
    assert v.read_mp4(str(tmp_path / "x.mp4")).samples == [
        cv2.imencode(".jpg", img[..., ::-1], params)[1].tobytes()]
    clip = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    for f in np.zeros((2, 32, 32, 3), np.uint8):
        writer.write(f)
    writer.release()
    # cv2's MPEG-4 Part 2 clip runs, and so does the port's own Motion-JPEG
    # .mp4 (clip_demo.mp4, read back); x.mp4 above is 21 rows high: its
    # frame is cv2's (swscale's scaling path) and the demo runs on it
    out = str(tmp_path / "clip_demo.mp4")
    main(["--video", clip, "--grid", "2", "--size", "32", "--out", out, "--device", "cpu"])
    assert v.read_video(out)[0].shape == (2, 32, 32, 3)
    again = str(tmp_path / "again.mp4")
    main(["--video", out, "--grid", "2", "--size", "32", "--out", again, "--device", "cpu"])
    assert v.read_video(again)[0].shape == (2, 32, 32, 3)
    from fgvc_tpu.cli.demo import load_video as jax_load_video
    from fgvc_tpu_torch.cli.demo import load_video

    np.testing.assert_array_equal(load_video(str(tmp_path / "x.mp4"), 32),
                                  jax_load_video(str(tmp_path / "x.mp4"), 32))
    odd_out = str(tmp_path / "odd_demo.mp4")
    main(["--video", str(tmp_path / "x.mp4"), "--grid", "2", "--size", "32", "--out", odd_out,
          "--device", "cpu"])
    assert v.read_video(odd_out)[0].shape == (1, 32, 32, 3)
    assert "H.264" in VIDEO_REFUSAL
    with pytest.raises(SystemExit, match="exactly one of --frames / --video"):
        main(["--video", "clip.mp4", "--frames", scene["frames"], "--device", "cpu"])
