"""Frames of odd height, which cv2 converts on swscale's scaling path: the
port's YUV -> BGR24 (fgvc_tpu_torch/csrc/swscale.cpp) against the
libswscale that cv2 ships, called through ctypes as cv2 sets it up
(SWS_BICUBIC at the frame's own size, BGR24 out, the stream's colour space,
range and chroma siting), on seeded planes: 4:2:0, 4:2:2 and 4:4:4, the
four colour spaces, both ranges, chroma centred or sited left, top or top
left, every size from 1 x 1, even heights (the unscaled path) among them;
and the port's
VideoReader against cv2.VideoCapture on odd-height streams of every YUV
codec it reads (VP9 in other colour spaces, MPEG-4 Part 2 in AVI, Motion-JPEG
at an odd width too; VP8, MPEG-4 Part 2 in MP4 and Motion-JPEG 4:2:0 in AVI
are in their codecs' modules); the four committed odd-height fixtures
against cv2's digests; run_task('kinetics', annotations=) over an
odd-height clip within 1e-6 of the JAX harness.

    python tests/test_torch_port_video_odd_height.py   # remakes the fixtures and their JSON
"""

import ctypes
import dataclasses
import glob
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import test_torch_port_eval_data as data
import test_torch_port_video_avi_mjpeg as mj
import test_torch_port_video_codec as codec
import test_torch_port_video_mpeg4 as mpeg4
import test_torch_port_video_pipeline as pipe
import test_torch_port_video_vp9_libvpx as v9

cv2 = pytest.importorskip("cv2")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "torch_port_fixtures")
# name -> (extension, width, height, frames)
FIXTURES = {"vp8_256x143_24f": (".webm", 256, 143, 24),
            "vp9_bt709_256x143_24f": (".webm", 256, 143, 24),
            "mp4v_255x143_24f": (".mp4", 255, 143, 24),
            "mjpg_422_256x143_12f": (".avi", 256, 143, 12)}
FIXTURE_BUDGET = 300_000  # bytes, the four clips together

# AVPixelFormat and SWS_CS_* values; the converter's chroma argument
YUV420P, BGR24, YUV422P, YUV444P = 0, 3, 4, 5
PIX_FMT = {2: YUV420P, 1: YUV422P, 0: YUV444P}
SWS_CS = {0: 5, 1: 1, 2: 7, 3: 9}  # ITU601, ITU709, SMPTE240M, BT2020
SWS_BICUBIC = 4
# AVChromaLocation -> (src_h_chr_pos, src_v_chr_pos): left, center,
# topleft, top, bottomleft, bottom; a siting moves only a subsampled axis
SITING = {1: (0, 128), 2: (128, 128), 3: (0, 0), 4: (128, 0), 5: (0, 256), 6: (128, 256)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Sws:
    """cv2's libswscale through ctypes: a context at one size in and out
    (sws_alloc_context, the options by name, sws_init_context), the
    colour space and range set as sws_setColorspaceDetails does."""

    def __init__(self):
        libdir = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
        sws, util = (glob.glob(os.path.join(libdir, f"lib{n}-*.so*")) for n in ("swscale",
                                                                                  "avutil"))
        if not sws or not util:
            pytest.skip("this cv2 ships no libswscale")
        self.util, self.sws = ctypes.CDLL(util[0]), ctypes.CDLL(sws[0])
        vp, i = ctypes.c_void_p, ctypes.c_int
        for lib, name, res, args in (
                (self.util, "av_opt_set_int", i, [vp, ctypes.c_char_p, ctypes.c_int64, i]),
                (self.sws, "sws_alloc_context", vp, []),
                (self.sws, "sws_init_context", i, [vp, vp, vp]),
                (self.sws, "sws_getCoefficients", ctypes.POINTER(i), [i]),
                (self.sws, "sws_setColorspaceDetails", i, [vp, ctypes.POINTER(i), i,
                                                          ctypes.POINTER(i), i, i, i, i]),
                (self.sws, "sws_scale", i, [vp, vp, vp, i, i, vp, vp]),
                (self.sws, "sws_freeContext", None, [vp])):
            getattr(lib, name).restype, getattr(lib, name).argtypes = res, args

    def convert(self, y, u, v, chroma=2, matrix=0, full=0, siting=0):
        h, w = y.shape
        xpos, ypos = SITING[siting] if siting else (-513, -513)
        ctx = self.sws.sws_alloc_context()
        try:
            for key, val in (("srcw", w), ("srch", h), ("src_format", PIX_FMT[chroma]),
                             ("dstw", w), ("dsth", h), ("dst_format", BGR24),
                             ("sws_flags", SWS_BICUBIC),
                             ("src_h_chr_pos", xpos if chroma else -513),
                             ("src_v_chr_pos", ypos if chroma == 2 else -513)):
                assert self.util.av_opt_set_int(ctx, key.encode(), val, 0) >= 0, key
            assert self.sws.sws_init_context(ctx, None, None) >= 0
            self.sws.sws_setColorspaceDetails(
                ctx, self.sws.sws_getCoefficients(SWS_CS[matrix]), full,
                self.sws.sws_getCoefficients(SWS_CS[0]), 0, 0, 1 << 16, 1 << 16)
            planes = [np.ascontiguousarray(p) for p in (y, u, v)]
            src = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in planes], None)
            src_strides = (ctypes.c_int * 4)(*[p.strides[0] for p in planes], 0)
            out = np.zeros((h, w * 3 + 64), np.uint8)  # room for swscale's writes past w
            dst = (ctypes.c_void_p * 4)(out.ctypes.data, None, None, None)
            dst_strides = (ctypes.c_int * 4)(out.strides[0], 0, 0, 0)
            assert self.sws.sws_scale(ctx, src, src_strides, 0, h, dst, dst_strides) == h
        finally:
            self.sws.sws_freeContext(ctx)
        return out[:, :w * 3].reshape(h, w, 3)


@pytest.fixture(scope="module")
def sws():
    return Sws()


def port_convert(y, u, v, chroma=2, matrix=0, full=0, siting=0):
    """The port's fgpack_yuv_to_bgr24: the frame and the path it took (0
    unscaled, 1 scaled, 2 full chroma)."""
    from fgvc_tpu_torch.data_io.fgpack import _load, _u8p

    h, w = y.shape
    out = np.empty((h, w, 3), np.uint8)
    path = _load().fgpack_yuv_to_bgr24(_u8p(y), _u8p(u), _u8p(v), y.strides[0], u.strides[0],
                                       h, w, chroma, matrix, full, siting, _u8p(out))
    return out, path


# case -> (chroma, colour spaces, ranges, siting); every case draws sizes
# up to 70 x 90 (up to 660 x 40 in 420-wide), odd and even heights, and one
# plane pair of 0/255 extremes in three (the bicubic overshoot and the
# full-chroma path's 32-bit wrap)
CONVERTER_CASES = {"420-bt601": (2, (0,), (0,), (0,)),
                   "420-spaces-ranges": (2, (1, 2, 3), (0, 1), (0,)),
                   "420-left": (2, (0,), (0,), (1,)), "420-top": (2, (0, 1), (0,), (2, 3, 4)),
                   "422": (1, (0, 1), (0, 1), (0, 1)),
                   "444": (0, (0, 3), (0, 1), (0, 1)), "420-wide": (2, (0, 1), (0, 1), (0, 1))}


@pytest.mark.parametrize("case", sorted(CONVERTER_CASES))
def test_converter_equals_libswscale(sws, case):
    """fgpack_yuv_to_bgr24 equals cv2's libswscale bit for bit on seeded
    planes; an odd height takes the scaling path (full chroma at an odd
    width or for 4:4:4), an even 4:2:x height the unscaled one."""
    chroma, spaces, ranges, sitings = CONVERTER_CASES[case]
    rng = np.random.default_rng(sorted(CONVERTER_CASES).index(case))
    hs, vs = int(chroma > 0), int(chroma == 2)
    paths = set()
    for trial in range(60):
        if case == "420-wide":
            w, h = int(rng.integers(300, 660)), int(rng.integers(2, 40))
        else:
            w, h = int(rng.integers(1, 70)), int(rng.integers(1, 90))
        extremes = trial % 3 == 2
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        u, v = (rng.integers(0, 2, ((h + vs) >> vs, (w + hs) >> hs)).astype(np.uint8) * 255
                if extremes else rng.integers(0, 256, ((h + vs) >> vs, (w + hs) >> hs),
                                              dtype=np.uint8) for _ in range(2))
        kw = dict(chroma=chroma, matrix=int(rng.choice(spaces)), full=int(rng.choice(ranges)),
                  siting=int(rng.choice(sitings)))
        got, path = port_convert(y, u, v, **kw)
        assert path == (0 if chroma and not h % 2 else 2 if w % 2 or not chroma else 1), (w, h)
        paths.add(path)
        ref = sws.convert(y, u, v, **kw)
        assert np.array_equal(got, ref), (case, w, h, kw, np.argwhere((got != ref).any(-1))[:4])
    assert paths == ({2} if chroma == 0 else {0, 1, 2})


def test_converter_refuses_bad_arguments():
    y = np.zeros((3, 4), np.uint8)
    u = np.zeros((2, 2), np.uint8)
    for kw in (dict(chroma=3), dict(matrix=4), dict(chroma=-1), dict(siting=7)):
        assert port_convert(y, u, u, **kw)[1] == -14, kw


# ---- streams of every YUV codec ---------------------------------------------

def assert_equals_cv2(path, shape, luma=True):
    """Every frame of `path` bit for bit as cv2 reads it, the count and the
    rate; the Y plane as CAP_PROP_CONVERT_RGB = 0 gives it (`luma`)."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    ref, meta = codec.cv2_read(path)
    grey, _ = codec.cv2_read(path, convert_rgb=False) if luma else (None, None)
    with VideoReader(path) as reader:
        got = []
        for frame in reader:
            got.append(frame)
            if luma:
                y = reader.planes()[0]
                assert np.array_equal(y, grey[len(got) - 1].reshape(y.shape)), len(got)
        assert (reader.frame_count, reader.fps) == meta
        feats = reader.features()
    assert len(got) == len(ref) > 0 and got[0].shape == shape
    for t, (a, b) in enumerate(zip(got, ref)):
        assert np.array_equal(a, b), (path, t, int(np.abs(a.astype(int) - b).max()))
    return feats


@pytest.fixture(scope="module")
def vpx():
    return v9.Vpx()


# case -> (width, height, VP9 colour space, full range)
VP9_CASES = {"bt709-96x63": (96, 63, 2, 0), "smpte240-full-96x59": (96, 59, 4, 1),
             "bt2020-95x63": (95, 63, 5, 0), "bt601-full-95x63": (95, 63, 1, 1)}


@pytest.mark.parametrize("case", sorted(VP9_CASES))
def test_vp9_colour_spaces_at_odd_heights_equal_cv2(vpx, tmp_path, case):
    """libvpx writes odd heights and odd widths in each colour space and
    range cv2 converts with other coefficients; the scaling path takes
    them as the unscaled path does."""
    w, h, space, full = VP9_CASES[case]
    packets = vpx.encode(codec.clip_frames(w, h + (h & 1), 4, seed=h)[:, :h],
                         controls=[(v9.COLOR_SPACE, space), (v9.COLOR_RANGE, full)])
    path = tmp_path / "odd.mkv"
    path.write_bytes(v9.mkv(packets, w, h))
    assert_equals_cv2(str(path), (h, w, 3), luma=False)


def _mpeg4_at(w, h, samples, dsi):
    def edit(bits, f):
        bits = bits[:f["width"]] + f"{w:013b}" + bits[f["width"] + 13:]
        return bits[:f["height"]] + f"{h:013b}" + bits[f["height"] + 13:]
    return mpeg4.rewrite_vol(dsi, edit)


@pytest.fixture(scope="module")
def mp4v_100x60(tmp_path_factory):
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = codec.write_clip(tmp_path_factory.mktemp("mp4v") / "even.mp4",
                            mpeg4.content("pan", 100, 60, 14, seed=3), "mp4v")
    with VideoReader(path) as src:
        return src.packets(), src.dsi


@pytest.mark.parametrize("size", [(100, 59), (99, 59)], ids=["100x59", "99x59"])
def test_mpeg4_avi_at_odd_heights_equals_cv2(mp4v_100x60, tmp_path, size):
    """MPEG-4 Part 2 in AVI (XVID) with the VOL rewritten to an odd height
    (and width): FFmpeg's decoder reports its chroma co-sited left, and
    cv2's swscale filters it from there."""
    samples, dsi = mp4v_100x60
    w, h = size
    path = tmp_path / "odd.avi"
    path.write_bytes(mj.build_avi(samples, w, h, fourcc=b"XVID", extradata=_mpeg4_at(w, h, samples,
                                                                                    dsi)))
    assert_equals_cv2(str(path), (h, w, 3))


@pytest.mark.parametrize("sampling", [2, 1, 0], ids=["420", "422", "444"])
def test_mjpeg_at_odd_width_and_height_equals_cv2(tmp_path, sampling):
    """PIL's JPEGs at 95 x 61 in AVI: every sampling on swscale's
    full-chroma path (an odd width forces it)."""
    frames = codec.clip_frames(96, 64, 4, seed=5)[:, :61, :95]
    path = tmp_path / "odd.avi"
    path.write_bytes(mj.build_avi(mj.pil_jpegs(frames, 80, sampling), 95, 61))
    feats = assert_equals_cv2(str(path), (61, 95, 3), luma=False)
    assert feats["full_chroma_conversions"] == 4


# ---- the committed fixtures -------------------------------------------------

def fixture_path(name):
    return os.path.join(FIXTURE_DIR, name + FIXTURES[name][0])


def make_fixture(name):
    """The clip's bytes, from cv2's and libvpx's encoders and PIL's JPEGs,
    cut to an odd height in the headers the decoders read (VP8 key frames,
    the MPEG-4 VOL) or written at it (libvpx, PIL)."""
    import tempfile

    from fgvc_tpu_torch.data_io.video import VideoReader

    _, w, h, n = FIXTURES[name]
    frames = codec.clip_frames(256, 144, n, seed=143)
    if name.startswith("vp9"):
        packets = v9.Vpx().encode(frames[:, :h, :w], controls=[(v9.COLOR_SPACE, 2)])
        return v9.mkv(packets, w, h)
    if name.startswith("mjpg"):
        return mj.build_avi(mj.pil_jpegs(frames[:, :h, :w], 75, 1), w, h)
    with tempfile.TemporaryDirectory() as tmp:  # cv2's 256 x 144 clip
        ext, fourcc = (".webm", "VP80") if name.startswith("vp8") else (".mp4", "mp4v")
        with VideoReader(codec.write_clip(os.path.join(tmp, "even" + ext), frames,
                                          fourcc)) as src:
            packets, keys, dsi = src.packets(), src.keys, src.dsi
    if name.startswith("vp8"):
        return codec.build_mkv(codec._resized(packets, keys, w, h), keys, w, h)
    return mpeg4.build_mp4(packets, _mpeg4_at(w, h, packets, dsi), w, h)


def test_fixtures_are_small():
    assert sum(os.path.getsize(fixture_path(n)) for n in FIXTURES) <= FIXTURE_BUDGET


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_pins_are_cv2s_and_the_port_decodes_to_them(name):
    """The JSON beside each fixture is cv2's record of it (frame digests,
    count, rate), and the port's reader gives those digests."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    with open(os.path.join(FIXTURE_DIR, name + ".json")) as f:
        pinned = json.load(f)
    _, w, h, n = FIXTURES[name]
    assert codec.fixture_record(fixture_path(name)) == pinned
    assert (pinned["width"], pinned["height"], pinned["frames"]) == (w, h, n)
    with VideoReader(fixture_path(name)) as reader:
        digests = [hashlib.sha256(f.tobytes()).hexdigest() for f in reader]
        assert (reader.frame_count, reader.fps) == (pinned["cv2_frame_count"], pinned["cv2_fps"])
    assert digests == pinned["sha256"]


# ---- end to end ---------------------------------------------------------------

@pytest.fixture(scope="module")
def odd_clips(tmp_path_factory, mp4v_100x60):
    """A Kinetics clip of odd width and height: MPEG-4 Part 2 at 99 x 59
    (cv2's 100 x 60 with the VOL rewritten; full chroma, sited left)."""
    base = tmp_path_factory.mktemp("odd_kinetics")
    clips = base / "clips"
    clips.mkdir()
    samples, dsi = mp4v_100x60
    samples = samples[:pipe.T]
    (clips / "clip_a.mp4").write_bytes(mpeg4.build_mp4(samples, _mpeg4_at(99, 59, samples, dsi),
                                                       99, 59))
    return {"clips": str(clips), "clip": str(clips / "clip_a.mp4"),
            "csv": pipe.write_csv(base / "ann.csv", ("clip_a",)),
            "pth": data.export_pth(base / "weights.pth", (pipe.H, pipe.W))}


def test_run_task_annotations_at_odd_heights_matches_jax(odd_clips):
    """run_task('kinetics', annotations=) over the odd-height clip gives
    the JAX harness's metrics (cv2's frames there) within 1e-6."""
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task

    assert_equals_cv2(odd_clips["clip"], (59, 99, 3))
    jax_cfg = dataclasses.replace(JAX_TASK_CONFIGS["kinetics"], **pipe.SMALL, frame_bucket=8,
                                  point_bucket=4, attention_impl="pallas")
    ref = jax_run_task("kinetics", odd_clips["clips"], checkpoint=odd_clips["pth"],
                       test_cfg=jax_cfg, annotations=odd_clips["csv"])
    out = run_task("kinetics", odd_clips["clips"], checkpoint=odd_clips["pth"],
                   test_cfg=dataclasses.replace(TASK_CONFIGS["kinetics"], **pipe.SMALL),
                   device="cpu", annotations=odd_clips["csv"])
    shared = sorted(set(ref) & set(out))
    assert "average_pts_within_thresh" in shared and "average_jaccard" in shared
    for k in shared:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=pipe.METRIC_TOL, atol=pipe.METRIC_TOL,
                                   err_msg=k)


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(HERE))  # the checkout's fgvc_tpu_torch
    total = 0
    for fixture in sorted(FIXTURES):
        with open(fixture_path(fixture), "wb") as f:
            f.write(make_fixture(fixture))
        with open(os.path.join(FIXTURE_DIR, fixture + ".json"), "w") as f:
            json.dump(codec.fixture_record(fixture_path(fixture)), f, indent=1)
        total += os.path.getsize(fixture_path(fixture))
        print(fixture_path(fixture), os.path.getsize(fixture_path(fixture)), "bytes")
    print("total", total, "bytes")
