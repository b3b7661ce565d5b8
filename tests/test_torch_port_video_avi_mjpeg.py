"""The port's AVI demuxer (fgvc_tpu_torch/csrc/avi.cpp) and Motion-JPEG
decoder (csrc/mjpeg.cpp, with fgpack.cpp's swscale conversions) behind
data_io/video.py, against cv2.VideoCapture: every frame bit for bit, with
CAP_PROP_FRAME_COUNT and CAP_PROP_FPS, for the files cv2.VideoWriter writes
here ('XVID', 'DIVX', 'FMP4' and 'mp4v' in .avi; 'MJPG' in .avi, .mp4 and
.mkv), for PIL's baseline JPEGs at 4:2:0, 4:2:2 and 4:4:4 (q50 and q95,
restart markers, no DHT) wrapped here into an AVI and an MP4, for the
port's own save_video .mp4, for AVI forms cv2's writer does not make
(absolute idx1 offsets, no idx1, empty chunks, VOL headers in strf's
extradata), and for unsigned MPEG-4 Part 2 streams under XviD's and DivX's
fourccs (FFmpeg's tag rules); the Motion-JPEG planes against cv2's
libavcodec mjpeg decoder through ctypes; each form still refused raising
ValueError by name; the committed fixtures against cv2's digests; and the
JAX package's decode_video, run_task('kinetics', annotations=) over
Motion-JPEG .mp4 and .mkv clips, and the demo's --video over an .avi.

    python tests/test_torch_port_video_avi_mjpeg.py   # remakes the three fixtures and JSONs
"""

import ctypes
import dataclasses
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
import torch

import test_torch_port_video_codec as codec
import test_torch_port_video_libavcodec as lavc_mod
import test_torch_port_video_mpeg4 as mp4v

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_port_fixtures")
# name -> (writer, frames, (w, h)): cv2's XVID and MJPG writers over the
# first 48 frames of the VP8 fixture's content, and the port's save_video
# over 24 of them cut to 320 x 180
FIXTURE_CLIPS = {"mp4v_640x360_48f.avi": ("XVID", 48, (640, 360)),
                 "mjpg_640x360_48f.avi": ("MJPG", 48, (640, 360)),
                 "mjpg_444_320x180_24f.mp4": ("save_video", 24, (320, 180))}
SIZES = ((96, 64), (34, 18), (130, 94))
WRITERS = (("XVID", "avi"), ("DIVX", "avi"), ("FMP4", "avi"), ("mp4v", "avi"), ("MJPG", "avi"),
           ("MJPG", "mp4"), ("MJPG", "mkv"))
H = W = 32
T = 13


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- containers built here -----------------------------------------------

def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def build_avi(packets, w, h, fourcc=b"MJPG", rate=25, scale=1, length=None, idx1=True,
              absolute=False, extradata=b"", streams=1, avix=False):
    """An AVI of one video stream ('00dc' chunks) as FFmpeg's muxer lays it
    out: avih, one strl a stream (strh with dwScale, dwRate, dwLength; strf
    a BITMAPINFOHEADER plus `extradata`), movi, and idx1 with offsets from
    movi's fourcc (or `absolute`); `streams` video strl lists (their chunks
    all stream 0's); `avix` appends an OpenDML continuation RIFF."""
    avih = struct.pack("<14I", 1000000 * scale // max(rate, 1), 0, 0, 0x10 if idx1 else 0,
                       len(packets), 0, streams, 0, w, h, 0, 0, 0, 0)
    strl = b""
    for _ in range(streams):
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, scale, rate, 0,
                           len(packets) if length is None else length, 0, 0xFFFFFFFF, 0,
                           0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), w, h, 1, 24, fourcc, w * h * 3,
                           0, 0, 0, 0) + extradata
        strl += _chunk(b"LIST", b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf))
    hdrl = _chunk(b"LIST", b"hdrl" + _chunk(b"avih", avih) + strl)
    movi, index = b"", []
    for p in packets:
        index.append((4 + len(movi), len(p)))
        movi += _chunk(b"00dc", p)
    body = hdrl + _chunk(b"LIST", b"movi" + movi)
    movi_at = 12 + len(hdrl) + 8  # the 'movi' fourcc's offset in the file
    if idx1:
        body += _chunk(b"idx1", b"".join(
            struct.pack("<4sIII", b"00dc", 0x10, o + (movi_at if absolute else 0), n)
            for o, n in index))
    out = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body
    if avix:
        out += _chunk(b"RIFF", b"AVIX" + _chunk(b"LIST", b"movi" + _chunk(b"00dc", packets[0])))
    return out


def pil_jpegs(frames, quality=95, subsampling=2, **kw):
    """(n, h, w, 3) BGR frames -> PIL's baseline JPEG bytes (subsampling 0
    4:4:4, 1 4:2:2, 2 4:2:0)."""
    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(f[..., ::-1])).save(
            buf, "JPEG", quality=quality, subsampling=subsampling, **kw)
        out.append(buf.getvalue())
    return out


def strip_dht(jpeg: bytes) -> bytes:
    """A JPEG without its DHT segments (PIL writes the standard tables, which
    FFmpeg's decoder falls back to)."""
    out, p = bytearray(jpeg[:2]), 2
    while jpeg[p + 1] != 0xDA:
        n = struct.unpack(">H", jpeg[p + 2:p + 4])[0]
        if jpeg[p + 1] != 0xC4:
            out += jpeg[p:p + 2 + n]
        p += 2 + n
    return bytes(out + jpeg[p:])


def wrap(packets, w, h, container, path, **kw):
    from fgvc_tpu_torch.utils.visualize import mp4_mjpeg

    data = build_avi(packets, w, h, **kw) if container == "avi" else mp4_mjpeg(packets, w, h, 25)
    path.write_bytes(data)
    return str(path)


def assert_reads_as_cv2(path, expect_frames=None, codec_name=None):
    """Every frame of `path` bit for bit as cv2 reads it, the same count
    of them, CAP_PROP_FRAME_COUNT and CAP_PROP_FPS; returns the features."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    ref, meta = codec.cv2_read(path)
    with VideoReader(path) as reader:
        if codec_name is not None:
            assert reader.codec == codec_name
        got = 0
        for t, frame in enumerate(reader):
            assert frame.shape == ref[t].shape and frame.dtype == np.uint8
            assert np.array_equal(frame, ref[t]), (path, t, int(np.abs(
                frame.astype(int) - ref[t]).max()))
            got += 1
        assert (reader.frame_count, reader.fps) == meta
        feats = reader.features()
    assert got == len(ref) == (expect_frames if expect_frames is not None else len(ref))
    return feats


# ---- cv2's writers ----------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fourcc,ext", WRITERS, ids=[f"{f}-{e}" for f, e in WRITERS])
def test_cv2_writers_equal_cv2(tmp_path, fourcc, ext, size):
    """cv2's MPEG-4 Part 2 AVI files and its Motion-JPEG AVI, MP4 and
    Matroska files, read as cv2 reads them."""
    w, h = size
    path = codec.write_clip(tmp_path / f"c.{ext}", codec.clip_frames(w, h, 14, seed=w + h),
                            fourcc, fps=10.0)
    name = {"avi": f"{fourcc} ({'Motion-JPEG' if fourcc == 'MJPG' else 'MPEG-4 Part 2'})",
            "mp4": "mp4v (JPEG)", "mkv": "V_MJPEG"}[ext]
    feats = assert_reads_as_cv2(path, expect_frames=14, codec_name=name)
    if fourcc == "MJPG":  # cv2's writer: 4:2:0 with a DHT in every frame
        assert feats["frames_420"] == feats["unscaled_420_conversions"] == 14
        assert feats["frames_without_dht"] == 0


@pytest.mark.parametrize("fps", [10.0, 24.0, 30000 / 1001, 50.0])
@pytest.mark.parametrize("fourcc", ["XVID", "MJPG"])
def test_rate_and_count_equal_cv2(tmp_path, fourcc, fps):
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = codec.write_clip(tmp_path / "r.avi", codec.clip_frames(48, 32, 7, seed=3), fourcc,
                            fps=fps)
    _, meta = codec.cv2_read(path)
    with VideoReader(path) as reader:
        assert (reader.frame_count, reader.fps) == meta
    assert meta[0] == 7


# ---- Motion-JPEG: PIL's JPEGs, FFmpeg's planes, the port's own output -------

@pytest.fixture(scope="module")
def lavc():
    return lavc_mod.Lavc()


@pytest.mark.parametrize("container", ["avi", "mp4"])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", [2, 1, 0], ids=["420", "422", "444"])
def test_pil_jpegs_equal_cv2(tmp_path, sampling, quality, container):
    """PIL's baseline JPEGs at each chroma sampling in an AVI and in an MP4:
    swscale's unscaled 4:2:0 and 4:2:2 paths and its full-chroma 4:4:4
    path (cv2 and PIL part by up to 15 on these files; the port is cv2)."""
    frames = codec.clip_frames(130, 94, 4, seed=sampling * 10 + quality)
    noise = np.random.default_rng(quality).integers(0, 256, (1, 94, 130, 3), dtype=np.uint8)
    packets = pil_jpegs(np.concatenate([frames, noise]), quality, sampling)
    feats = assert_reads_as_cv2(wrap(packets, 130, 94, container, tmp_path / f"p.{container}"),
                                expect_frames=5)
    key = {2: "420", 1: "422", 0: "444"}[sampling]
    conv = {2: "unscaled_420", 1: "unscaled_422", 0: "full_chroma"}[sampling]
    assert feats[f"frames_{key}"] == feats[f"{conv}_conversions"] == 5


@pytest.mark.parametrize("form", ["restart-markers", "no-dht"])
def test_restart_markers_and_standard_tables_equal_cv2(tmp_path, form):
    """Restart intervals (the DC predictors start afresh at each RSTn) and
    frames without a DHT (FFmpeg's standard tables), each sampling."""
    frames = codec.clip_frames(96, 64, 3, seed=7)
    for sampling in (0, 1, 2):
        if form == "restart-markers":
            packets = pil_jpegs(frames, 75, sampling, restart_marker_blocks=3)
            assert all(b"\xff\xdd" in p for p in packets)
        else:
            packets = [strip_dht(p) for p in pil_jpegs(frames, 75, sampling)]
        feats = assert_reads_as_cv2(wrap(packets, 96, 64, "avi", tmp_path / f"{sampling}.avi"),
                                    expect_frames=3)
        assert feats["frames_with_restarts" if form == "restart-markers"
                     else "frames_without_dht"] == 3


def lavc_mjpeg_planes(lavc, packets):
    """[(pixel format, (Y, U, V))] of cv2's libavcodec mjpeg decoder."""
    av, util = lavc.av, lavc.util
    ctx = lavc._ctx(av.avcodec_find_decoder_by_name(b"mjpeg"), {})
    pkt, frame = av.av_packet_alloc(), util.av_frame_alloc()
    out = []

    def drain():
        while av.avcodec_receive_frame(ctx, frame) == 0:
            w, h, fmt = (ctypes.c_int.from_address(frame + o).value for o in (104, 108, 116))
            hs, vs = {12: (1, 1), 13: (1, 0), 14: (0, 0)}[fmt]
            planes = []
            for p, (pw, ph) in enumerate([(w, h)] + [((w + hs) >> hs, (h + vs) >> vs)] * 2):
                ptr = ctypes.c_void_p.from_address(frame + 8 * p).value
                stride = ctypes.c_int.from_address(frame + 64 + 4 * p).value
                rows = [ctypes.string_at(ptr + r * stride, pw) for r in range(ph)]
                planes.append(np.frombuffer(b"".join(rows), np.uint8).reshape(ph, pw))
            out.append((fmt, tuple(planes)))
            util.av_frame_unref(frame)

    for p in packets:
        assert av.av_new_packet(pkt, len(p)) == 0
        ctypes.memmove(ctypes.c_void_p.from_address(pkt + lavc_mod.PKT_DATA).value, p, len(p))
        av.avcodec_send_packet(ctx, pkt)
        av.av_packet_unref(pkt)
        drain()
    av.avcodec_send_packet(ctx, None)
    drain()
    util.av_frame_free(ctypes.byref(ctypes.c_void_p(frame)))
    av.av_packet_free(ctypes.byref(ctypes.c_void_p(pkt)))
    av.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
    return out


def test_planes_equal_libavcodec_mjpeg(lavc):
    """The decoder's planes at each sampling equal the mjpeg decoder of the
    libavcodec that cv2 ships (through ctypes), before any conversion."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    frames = codec.clip_frames(130, 94, 3, seed=11)
    for sampling, fmt in ((2, 12), (1, 13), (0, 14)):  # AV_PIX_FMT_YUVJ420P, 422P, 444P
        packets = pil_jpegs(frames, 90, sampling, restart_marker_blocks=5)
        ref = lavc_mjpeg_planes(lavc, packets)
        with VideoReader(build_avi(packets, 130, 94)) as reader:
            for t, _ in enumerate(reader):
                got = reader.planes()
                assert ref[t][0] == fmt
                for a, b in zip(got, ref[t][1]):
                    np.testing.assert_array_equal(a, b, err_msg=f"{sampling} {t}")


def test_save_video_reads_equal_cv2(tmp_path):
    """The port's own save_video .mp4 (4:4:4 q95 Motion-JPEG), read back as
    cv2 reads it."""
    from fgvc_tpu_torch.utils.visualize import save_video

    path = str(tmp_path / "demo.mp4")
    save_video(codec.clip_frames(64, 48, 6, seed=12)[..., ::-1], path)
    feats = assert_reads_as_cv2(path, expect_frames=6, codec_name="mp4v (JPEG)")
    assert feats["frames_444"] == feats["full_chroma_conversions"] == 6


# ---- AVI forms and MPEG-4 Part 2 behind AVI --------------------------------

def _unsigned(packets):
    """The packets without the first one's user data (libavcodec's 'Lavc'
    signature): FFmpeg's rules for unsigned streams then read the tag."""
    at = packets[0].find(b"\x00\x00\x01\xb2")
    end = packets[0].index(b"\x00\x00\x01", at + 4)
    return [packets[0][:at] + packets[0][end:]] + packets[1:]


def _divx4_vol(bits, fields):
    """A VOL rewritten to video_object_type_indication 0 without
    vol_control_parameters (what FFmpeg takes for DivX 4 under 'DIVX')."""
    p = 9 + (8 if bits[9] == "1" else 1)
    p += 4 + (16 if int(bits[p:p + 4], 2) == 15 else 0)
    if bits[p] == "1":
        bits = bits[:p] + "0" + bits[p + 5 + (79 if bits[p + 4] == "1" else 0):]
    return bits[:1] + "0" * 8 + bits[9:]


@pytest.mark.parametrize("fourcc", ["XVID", "xvid", "DIVX", "FMP4"])
def test_unsigned_streams_follow_the_tag_rules(lavc, tmp_path, fourcc):
    """An unsigned stream is XviD build 0 under 'XVID' (either case: XviD's
    IDCT, the edge and DC workarounds) and DivX 4 under 'DIVX' where its VOL
    has vo_type 0 without vol control (the edge workaround); 'FMP4' keeps
    neither.  Each tag changes cv2's pixels of the same stream, and the port
    gives cv2's."""
    packets = _unsigned(lavc.encode(lavc_mod.fast_pan(100, 60), {"flags": "+mv4"}))
    packets[0] = mp4v.rewrite_vol(packets[0], _divx4_vol)
    path = str(tmp_path / "u.avi")
    with open(path, "wb") as f:
        f.write(build_avi(packets, 100, 60, fourcc=fourcc.encode()))
    feats = assert_reads_as_cv2(path, expect_frames=lavc_mod.N)
    assert (feats["xvid_idct_vops"] > 0) == (fourcc.upper() == "XVID")
    assert feats["mbs_reading_past_edge"] > 0
    plain = str(tmp_path / "plain.avi")
    with open(plain, "wb") as f:
        f.write(build_avi(packets, 100, 60, fourcc=b"FMP4"))
    if fourcc != "FMP4":
        assert any(not np.array_equal(a, b) for a, b in zip(codec.cv2_read(path)[0],
                                                             codec.cv2_read(plain)[0]))


@pytest.mark.parametrize("form", ["absolute-idx1", "no-idx1", "empty-chunk", "no-length",
                                  "extradata", "zero-rate"])
def test_avi_forms_equal_cv2(tmp_path, form):
    """AVI forms cv2's writer does not make, read as cv2 reads them: idx1
    offsets from the file's start, no idx1 (movi scanned), an empty chunk
    (no frame; dwLength counts it), dwLength 0 (a count of 0), the VOL
    headers in strf's extradata instead of the first chunk, dwRate 0
    (avidec's 25 fps)."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    src = codec.write_clip(tmp_path / "src.avi", codec.clip_frames(64, 48, 6, seed=5), "XVID")
    with VideoReader(src) as reader:
        packets = reader.packets()
    kw = {"absolute-idx1": dict(absolute=True), "no-idx1": dict(idx1=False),
          "no-length": dict(length=0), "zero-rate": dict(rate=0, scale=0)}.get(form, {})
    if form == "empty-chunk":
        packets = packets[:3] + [b""] + packets[3:]
    if form == "extradata":
        vop = packets[0].index(b"\x00\x00\x01\xb6")
        kw["extradata"], packets = packets[0][:vop], [packets[0][vop:]] + packets[1:]
    path = str(tmp_path / "f.avi")
    with open(path, "wb") as f:
        f.write(build_avi(packets, 64, 48, fourcc=b"XVID", **kw))
    assert_reads_as_cv2(path, expect_frames=6)
    with VideoReader(path) as reader:
        assert reader.frame_count == {"empty-chunk": 7, "no-length": 0}.get(form, 6)
        if form == "extradata":
            assert reader.dsi.startswith(b"\x00\x00\x01\xb0")


# ---- what stays refused ------------------------------------------------------

def _sof(jpeg: bytes, marker=None, precision=None) -> bytes:
    """A JPEG with its SOF0 marker or its sample precision rewritten."""
    b = bytearray(jpeg)
    at = b.index(b"\xff\xc0")
    if marker is not None:
        b[at + 1] = marker
    if precision is not None:
        b[at + 4] = precision
    return bytes(b)


REFUSALS = {
    "avix": "AVIX", "i420": "'I420'", "h264": "'H264'", "two-video-streams": "more than one video",
    "interlaced": "interlaced Motion-JPEG", "progressive": "progressive Motion-JPEG",
    "arithmetic": "arithmetic-coded", "lossless": "lossless Motion-JPEG", "12-bit": "12-bit",
    "greyscale": "greyscale Motion-JPEG", "not-avi-riff": "not a container",
    "odd-height": "odd frame height 63", "mp4-jpeg-entry": "video codec 'jpeg",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_what_was_found(case):
    """Each form the port does not read raises ValueError naming it (cv2
    reads most of them; the port refuses rather than decode them
    otherwise)."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    frames = codec.clip_frames(96, 64, 3, seed=2)
    jpegs = pil_jpegs(frames, 80, 2)
    kw, w, h = {}, 96, 64
    if case == "avix":
        kw["avix"] = True
    elif case == "i420":
        kw["fourcc"], jpegs = b"I420", [bytes(96 * 64 * 3 // 2)] * 3
    elif case == "h264":
        kw["fourcc"], jpegs = b"H264", [b"\x00\x00\x00\x01\x67\x42"] * 3
    elif case == "two-video-streams":
        kw["streams"] = 2
    elif case == "interlaced":  # two 96 x 32 fields a packet in a 96 x 64 stream
        jpegs = pil_jpegs(frames[:, :32], 80, 2)
    elif case == "progressive":
        jpegs = pil_jpegs(frames, 80, 2, progressive=True)
    elif case in ("arithmetic", "lossless"):
        jpegs = [_sof(j, marker=0xC9 if case == "arithmetic" else 0xC3) for j in jpegs]
    elif case == "12-bit":
        jpegs = [_sof(j, precision=12) for j in jpegs]
    elif case == "greyscale":
        jpegs = []
        for f in frames:
            buf = io.BytesIO()
            Image.fromarray(f[..., 0]).save(buf, "JPEG")
            jpegs.append(buf.getvalue())
    elif case == "odd-height":
        jpegs, h = pil_jpegs(frames[:, :63], 80, 2), 63
    data = build_avi(jpegs, w, h, **kw)
    if case == "not-avi-riff":
        data = data[:8] + b"WAVE" + data[12:]
    elif case == "mp4-jpeg-entry":  # QuickTime's 'jpeg' sample entry: no writer here makes it
        from fgvc_tpu_torch.utils.visualize import mp4_mjpeg

        data = mp4_mjpeg(jpegs, w, h, 25).replace(b"mp4v", b"jpeg", 1)
    with pytest.raises(ValueError, match=REFUSALS[case]):
        with VideoReader(data) as reader:
            list(reader)


# ---- the committed fixtures ----------------------------------------------------

def fixture_bytes(name):
    """The fixture remade here: cv2's writer (or save_video) over the VP8
    fixture's content (test_torch_port_video_codec.fixture_frames, RGB)."""
    from fgvc_tpu_torch.utils.visualize import save_video

    writer, n, (w, h) = FIXTURE_CLIPS[name]
    frames = codec.fixture_frames(n=n)
    if (w, h) != (640, 360):
        frames = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_AREA) for f in frames])
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, name)
        if writer == "save_video":
            save_video(frames, path)
        else:
            codec.write_clip(path, frames[..., ::-1], writer)
        with open(path, "rb") as f:
            return f.read()


@pytest.mark.parametrize("name", sorted(FIXTURE_CLIPS))
def test_fixture_remade_by_cv2_holds_its_pins(name):
    """The fixture is what its writer makes of the content today, cv2 reads
    it to its JSON's digests, count and fps, and the three keep to about
    1.5 MB together."""
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        assert f.read() == fixture_bytes(name)
    with open(path.rsplit(".", 1)[0] + ".json") as f:
        pinned = json.load(f)
    assert codec.fixture_record(path) == pinned
    writer, n, (w, h) = FIXTURE_CLIPS[name]
    assert (pinned["width"], pinned["height"], pinned["frames"]) == (w, h, n)
    assert sum(os.path.getsize(os.path.join(FIXTURES, k)) for k in FIXTURE_CLIPS) < 1_750_000


@pytest.mark.parametrize("name", sorted(FIXTURE_CLIPS))
def test_fixture_decodes_to_pinned_digests(name):
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = os.path.join(FIXTURES, name)
    with open(path.rsplit(".", 1)[0] + ".json") as f:
        pinned = json.load(f)
    with VideoReader(path) as reader:
        digests = [hashlib.sha256(f.tobytes()).hexdigest() for f in reader]
        assert (reader.frame_count, reader.fps) == (pinned["cv2_frame_count"], pinned["cv2_fps"])
    assert digests == pinned["sha256"]


# ---- the JAX package's video path over AVI and Motion-JPEG clips -------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import test_torch_port_eval_data as data
    import test_torch_port_video_pipeline as pipeline

    base = tmp_path_factory.mktemp("avi_mjpeg_pipeline")
    clips = base / "clips"
    clips.mkdir()
    codec.write_clip(clips / "clip_a.mp4", codec.clip_frames(48, 40, T, seed=40), "MJPG")
    codec.write_clip(clips / "clip_b.mkv", codec.clip_frames(48, 40, T, seed=41), "MJPG")
    avi = codec.write_clip(base / "clip.avi", codec.clip_frames(48, 40, T, seed=42), "XVID")
    mjpg_avi = codec.write_clip(base / "mjpg.avi", codec.clip_frames(48, 40, T, seed=43), "MJPG")
    refused = base / "refused"
    refused.mkdir()
    jpegs = pil_jpegs(codec.clip_frames(48, 40, 4, seed=44), 80, 2, progressive=True)
    (refused / "clip_p.mkv").write_bytes(codec.build_mkv(jpegs, [1] * 4, 48, 40,
                                                         codec=b"V_MJPEG"))
    return {"clips": str(clips), "avi": avi, "mjpg_avi": mjpg_avi, "base": base,
            "csv": pipeline.write_csv(base / "ann.csv", ("clip_a", "clip_b"), seed=6),
            "refused": str(refused),
            "refused_csv": pipeline.write_csv(base / "ref.csv", ("clip_p",), seed=7),
            "pth": data.export_pth(base / "weights.pth", (H, W))}


def test_decode_video_avi_equals_jax(tree):
    """decode_video and the stages over cv2's XVID and MJPG .avi, as the JAX
    package's give them through cv2 (resize (256, 256) among them)."""
    import fgvc_tpu.datasets.video_decode as jax_vd
    import fgvc_tpu_torch.datasets.video_decode as vd

    for clip in (tree["avi"], tree["mjpg_avi"]):
        for resize in (None, (256, 256)):
            np.testing.assert_array_equal(vd.decode_video(clip, resize=resize),
                                          jax_vd.decode_video(clip, resize=resize))
        a = vd.VideoInit()({"filename": clip})
        assert a == jax_vd.VideoInit()({"filename": clip}) and a["total_frames"] == T
        inds = np.array([0, 4, 12, T + 1])
        a = vd.VideoDecode()({"filename": clip, "frame_inds": inds})
        b = jax_vd.VideoDecode()({"filename": clip, "frame_inds": inds})
        for x, y in zip(a["imgs"], b["imgs"]):
            np.testing.assert_array_equal(x, y)


def test_run_task_annotations_mjpeg_matches_jax(tree):
    """run_task('kinetics', annotations=CSV) over Motion-JPEG .mp4 and .mkv
    clips within 1e-6 of the JAX harness (which decodes them with cv2) on
    the same weights."""
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task

    small = dict(neighbor_range=8, tile=8, input_size=(H, W))
    jax_cfg = dataclasses.replace(JAX_TASK_CONFIGS["kinetics"], **small, frame_bucket=8,
                                  point_bucket=4, attention_impl="pallas")
    ref = jax_run_task("kinetics", tree["clips"], checkpoint=tree["pth"], test_cfg=jax_cfg,
                       annotations=tree["csv"])
    out = run_task("kinetics", tree["clips"], checkpoint=tree["pth"], device="cpu",
                   test_cfg=dataclasses.replace(TASK_CONFIGS["kinetics"], **small),
                   annotations=tree["csv"])
    shared = sorted(set(ref) & set(out))
    assert "average_pts_within_thresh" in shared and "average_jaccard" in shared
    for k in shared:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_demo_video_avi_runs(tree):
    """The demo's --video over cv2's XVID and MJPG .avi (its loader equal to
    the JAX demo's), and over its own .mp4 output read back."""
    from fgvc_tpu.cli.demo import load_video as jax_load_video
    from fgvc_tpu_torch.cli.demo import load_video, main
    from fgvc_tpu_torch.utils.visualize import read_video

    for clip in (tree["avi"], tree["mjpg_avi"]):
        np.testing.assert_array_equal(load_video(clip, 32, stride=2, max_frames=3),
                                      jax_load_video(clip, 32, stride=2, max_frames=3))
    out = str(tree["base"] / "demo.mp4")
    main(["--video", tree["avi"], "--stride", "2", "--max-frames", "3", "--grid", "2",
          "--size", "32", "--out", out, "--device", "cpu"])
    assert read_video(out)[0].shape == (3, 32, 32, 3)
    again = str(tree["base"] / "again.mp4")
    main(["--video", out, "--grid", "2", "--size", "32", "--out", again, "--device", "cpu"])
    assert read_video(again)[0].shape == (3, 32, 32, 3)


def test_refused_clip_stops_the_dataset_decode_and_demo(tree):
    """A clip the port cannot decode (progressive Motion-JPEG in Matroska,
    which cv2 reads) stops the dataset, decode_video and the demo with the
    clip's path and what was found; it is not skipped."""
    from fgvc_tpu_torch.cli.demo import main
    from fgvc_tpu_torch.datasets.tapvid_kinetics import TapVidKineticsVideoDataset
    from fgvc_tpu_torch.datasets.video_decode import VideoInit, decode_video

    path = os.path.join(tree["refused"], "clip_p.mkv")
    assert len(codec.cv2_read(path)[0]) == 4
    ds = TapVidKineticsVideoDataset(tree["refused"], tree["refused_csv"], input_size=(H, W))
    with pytest.raises(ValueError, match=f"{path}.*progressive Motion-JPEG"):
        ds[0]
    for fn in (decode_video, lambda p: VideoInit()({"filename": p})):
        with pytest.raises(ValueError, match="progressive Motion-JPEG"):
            fn(path)
    with pytest.raises(SystemExit, match="progressive Motion-JPEG.*ROADMAP"):
        main(["--video", path, "--grid", "2", "--size", "32", "--out",
              str(tree["base"] / "p.mp4"), "--device", "cpu"])


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(HERE))  # the checkout's packages
    for fixture in FIXTURE_CLIPS:
        target = os.path.join(FIXTURES, fixture)
        with open(target, "wb") as fh:
            fh.write(fixture_bytes(fixture))
        with open(target.rsplit(".", 1)[0] + ".json", "w") as fh:
            json.dump(codec.fixture_record(target), fh, indent=1)
        print(target, os.path.getsize(target), "bytes")
