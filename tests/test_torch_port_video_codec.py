"""The port's video reader (fgvc_tpu_torch/data_io/video.py: the WebM
demuxer, the VP8 decoder and swscale's YUV -> BGR of csrc/fgpack.cpp)
against cv2.VideoCapture on clips that cv2.VideoWriter writes here with
libvpx ('VP80'): packets byte for byte (CAP_PROP_FORMAT = -1), the luma
plane against cv2's CAP_PROP_CONVERT_RGB = 0 plane (the decoder's Y plane
as it is), every BGR frame bit for bit, the frame count and rate; Matroska
forms cv2's writer does not make (unknown sizes, BlockGroups) on files built
here from its packets; what is refused (other codecs, laced blocks,
ContentEncoding, two video tracks) by name, and cv2's MPEG-4 Part 2 .mp4
read under the name it was once refused by; the committed 640 x 360 fixture
against its digests.  Seeded numpy content: panning smooth noise, a moving
disc and box, and a wrap of the pan that forces new key frames.

    python tests/test_torch_port_video_codec.py   # remakes the fixture and its JSON
"""

import hashlib
import json
import os
import re
import struct

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_port_fixtures", "vp8_640x360_250f.webm")
FIXTURE_JSON = os.path.join(HERE, "torch_port_fixtures", "vp8_640x360_250f.json")
# name -> (width, height, frames): 12-frame GOPs (cv2's default) and sizes
# that are not multiples of 16 (cv2's writer makes even sizes only; odd ones
# are built from these below)
CLIPS = {"96x64": (96, 64, 30), "100x60": (100, 60, 26), "34x18": (34, 18, 14),
         "130x94": (130, 94, 25), "250x142": (250, 142, 30)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module: the suite's
    workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def clip_frames(w, h, n, seed=0):
    """(n, h, w, 3) uint8 BGR: smooth noise panned 5 and 3 pixels a frame
    (wrapping, which makes the encoder start new key frames), a disc on a
    curve and a box moving right."""
    rng = np.random.default_rng(seed)
    bg = cv2.resize(rng.integers(0, 255, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8),
                    (w * 2, h * 2), interpolation=cv2.INTER_CUBIC)
    out = []
    for i in range(n):
        f = np.ascontiguousarray(bg[(i * 3) % h:(i * 3) % h + h, (i * 5) % w:(i * 5) % w + w])
        cv2.circle(f, (int(w / 2 + w / 3 * np.sin(i / 5)), int(h / 2 + h / 3 * np.cos(i / 7))),
                   max(4, h // 6), (0, 200, 100), -1)
        x0 = int(w / 4 + i * 3) % w
        cv2.rectangle(f, (x0, h // 4), (x0 + w // 8, h // 4 + h // 8), (255, 50, 50), -1)
        out.append(f)
    return np.stack(out)


def write_clip(path, frames, fourcc="VP80", fps=25.0):
    """Write (n, h, w, 3) BGR frames with cv2.VideoWriter; skip where this
    cv2 has no such encoder."""
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not writer.isOpened():
        pytest.skip(f"no {fourcc} encoder in this cv2 build")
    for f in frames:
        writer.write(np.ascontiguousarray(f))
    writer.release()
    return str(path)


def cv2_read(path, convert_rgb=True, raw=False):
    cap = cv2.VideoCapture(str(path))
    if raw:
        cap.set(cv2.CAP_PROP_FORMAT, -1)
    if not convert_rgb:
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.tobytes() if raw else f)
    meta = (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS))
    cap.release()
    return out, meta


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    base = tmp_path_factory.mktemp("vp8")
    return {name: write_clip(base / f"{name}.webm", clip_frames(w, h, n, seed=w))
            for name, (w, h, n) in CLIPS.items()}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_packets_equal_cv2(clips, name):
    from fgvc_tpu_torch.data_io.video import VideoReader

    ref, _ = cv2_read(clips[name], raw=True)
    with VideoReader(clips[name]) as reader:
        assert reader.codec == "V_VP8"
        assert (reader.width, reader.height) == CLIPS[name][:2]
        assert reader.packets() == ref
        # SimpleBlock key flags: the VP8 frame tags' (every 12th frame, and
        # more where the pan wraps)
        assert list(reader.keys) == [int(not p[0] & 1) for p in ref]
        assert reader.keys[0] == 1 and 0 < reader.keys.sum() < len(ref)


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_frames_equal_cv2(clips, name):
    """Every frame as cv2.VideoCapture.read gives it, bit for bit, the same
    number of them, and CAP_PROP_FRAME_COUNT / CAP_PROP_FPS."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    ref, (count, fps) = cv2_read(clips[name])
    with VideoReader(clips[name]) as reader:
        got = list(reader)
        assert (reader.frame_count, reader.fps) == (count, fps)
    assert len(got) == len(ref) == CLIPS[name][2]
    for t, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.array_equal(a, b), (name, t, int(np.abs(a.astype(int) - b).max()))


@pytest.mark.parametrize("name", ["96x64", "34x18"])
def test_luma_equals_cv2_grey_plane(clips, name):
    """With CAP_PROP_CONVERT_RGB = 0 cv2 returns the decoded frame's first
    plane (its log: 'yuv420p, will be treated as 8UC1'), the decoder's Y."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    ref, _ = cv2_read(clips[name], convert_rgb=False)
    with VideoReader(clips[name]) as reader:
        for t, grey in enumerate(ref):
            assert reader.read() is not None
            y, u, v = reader.planes()
            w, h = CLIPS[name][:2]
            assert u.shape == v.shape == ((h + 1) // 2, (w + 1) // 2)
            assert np.array_equal(y, grey.reshape(y.shape)), (name, t)


@pytest.mark.parametrize("fps", [24.0, 30000 / 1001, 29.97, 12.5])
def test_rate_and_count_equal_cv2(tmp_path, fps):
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = write_clip(tmp_path / "r.webm", clip_frames(48, 32, 23, seed=3), fps=fps)
    _, meta = cv2_read(path)
    with VideoReader(path) as reader:
        assert (reader.frame_count, reader.fps) == meta


def test_vp8_features_exercised(clips):
    """The clips reach inter frames, SPLITMV (4x4 too), golden and altref
    references, intra macroblocks in inter frames and the loop filter's
    reference and mode deltas; the counts are printed for the record."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    total = {}
    for name in sorted(CLIPS):
        with VideoReader(clips[name]) as reader:
            for _ in reader:
                pass
            for k, v in reader.features().items():
                total[k] = total.get(k, 0) + v
    print("VP8 features over the clips:", json.dumps(total))
    for key in ("key_frames", "inter_frames", "splitmv_mbs", "splitmv_4x4_mbs", "golden_mbs",
                "altref_mbs", "intra_mbs_in_inter_frames", "bpred_mbs_in_inter_frames",
                "frames_with_lf_deltas", "newmv_mbs", "nearmv_mbs", "nearestmv_mbs",
                "zeromv_mbs", "mbs_reading_past_edge"):
        assert total[key] > 0, key


# ---- Matroska built here from cv2's packets -----------------------------

def _el(eid: int, payload: bytes, unknown: bool = False) -> bytes:
    size = b"\x01\xff\xff\xff\xff\xff\xff\xff" if unknown else b"\x01" + len(payload).to_bytes(7, "big")
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big") + size + payload


def _uint(eid: int, v: int) -> bytes:
    return _el(eid, v.to_bytes(8, "big"))


def build_mkv(packets, keys, w, h, codec=b"V_VP8", unknown=True, block_groups=True,
              lacing=False, encoding=False, video_tracks=1, doc_type=b"webm", colour=None):
    """A Matroska file of the packets (40 ms apart) in clusters of 8:
    unknown-size Segment and Clusters, BlockGroups (ReferenceBlock on
    inter frames) or SimpleBlocks, and the refusal cases' variants;
    `colour` maps the IDs of a Colour element's children (ChromaSitingHorz
    0x55B7, ...) to the values it states."""
    head = _el(0x1A45DFA3, _uint(0x4286, 1) + _uint(0x42F7, 1) + _uint(0x42F2, 4)
               + _uint(0x42F3, 8) + _el(0x4282, doc_type) + _uint(0x4287, 2) + _uint(0x4285, 2))
    info = _el(0x1549A966, _uint(0x2AD7B1, 1_000_000) + _el(0x4489, struct.pack(">d", 40.0 * len(packets)))
               + _el(0x4D80, b"fgvc") + _el(0x5741, b"fgvc"))
    colour = b"" if colour is None else _el(0x55B0, b"".join(_uint(k, v) for k, v in colour.items()))
    entries = b""
    for t in range(video_tracks):
        entry = (_uint(0xD7, t + 1) + _uint(0x73C5, t + 1) + _uint(0x83, 1) + _el(0x86, codec)
                 + _uint(0x23E383, 40_000_000) + _el(0xE0, _uint(0xB0, w) + _uint(0xBA, h) + colour))
        if encoding:
            entry += _el(0x6D80, _el(0x6240, _uint(0x5031, 0) + _uint(0x5032, 1) + _uint(0x5033, 0)
                                      + _el(0x5034, _uint(0x4254, 3) + _el(0x4255, b"\x00"))))
        entries += _el(0xAE, entry)
    tracks = _el(0x1654AE6B, entries)
    body = b""
    for c in range(0, len(packets), 8):
        cluster = _uint(0xE7, 40 * c)
        for i in range(c, min(c + 8, len(packets))):
            rel = (40 * (i - c)).to_bytes(2, "big")
            if lacing:
                payload = b"\x81" + rel + b"\x86" + b"\x01" + bytes([len(packets[i]) & 0xFF]) + packets[i]
                cluster += _el(0xA3, payload)
            elif block_groups:
                group = _el(0xA1, b"\x81" + rel + b"\x00" + packets[i])
                if not keys[i]:
                    group += _el(0xFB, (-40).to_bytes(2, "big", signed=True))
                cluster += _el(0xA0, group)
            else:
                cluster += _el(0xA3, b"\x81" + rel + (b"\x80" if keys[i] else b"\x00") + packets[i])
        body += _el(0x1F43B675, cluster, unknown=unknown)
    return head + _el(0x18538067, info + tracks + body, unknown=unknown)


@pytest.mark.parametrize("form", ["unknown-sizes-block-groups", "known-sizes-simple-blocks",
                                  "matroska-doctype"])
def test_matroska_forms_equal_cv2(clips, tmp_path, form):
    from fgvc_tpu_torch.data_io.video import VideoReader

    with VideoReader(clips["100x60"]) as src:
        packets, keys = src.packets(), src.keys
    kw = {"unknown-sizes-block-groups": {},
          "known-sizes-simple-blocks": dict(unknown=False, block_groups=False),
          "matroska-doctype": dict(doc_type=b"matroska", unknown=False)}[form]
    path = tmp_path / "built.mkv"
    path.write_bytes(build_mkv(packets, keys, 100, 60, **kw))
    ref, (count, fps) = cv2_read(path)
    raw, _ = cv2_read(path, raw=True)
    with VideoReader(str(path)) as reader:
        assert reader.packets() == raw == packets
        got = list(reader)
        assert (reader.frame_count, reader.fps) == (count, fps)
    assert len(got) == len(ref) == len(packets)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def _resized(packets, keys, w, h):
    """The packets with each key frame's header saying (w, h): the same
    macroblocks, cut to another size by the decoder."""
    return [p[:6] + w.to_bytes(2, "little") + h.to_bytes(2, "little") + p[10:] if k else p
            for p, k in zip(packets, keys)]


def test_odd_width_equals_cv2_and_odd_height_equals_cv2(clips, tmp_path):
    """An odd width (a key-frame header of 97 on 100 x 60's macroblocks)
    converts on swscale's unscaled path and equals cv2 bit for bit; an odd
    height takes swscale's scaling path (bicubic chroma rows; full chroma
    at an odd width too) and equals cv2 as well, the luma plane as
    CAP_PROP_CONVERT_RGB = 0 gives it."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    with VideoReader(clips["100x60"]) as src:
        packets, keys = src.packets(), src.keys
    for w, h in ((97, 60), (99, 59), (100, 57)):
        path = tmp_path / f"odd_{w}x{h}.mkv"
        path.write_bytes(build_mkv(_resized(packets, keys, w, h), keys, w, h))
        ref, meta = cv2_read(path)
        grey, _ = cv2_read(path, convert_rgb=False)
        with VideoReader(str(path)) as reader:
            got, luma = [], []
            for frame in reader:
                got.append(frame)
                luma.append(reader.planes()[0])
            assert (reader.frame_count, reader.fps) == meta
        assert len(got) == len(ref) == len(packets) and got[0].shape == (h, w, 3)
        assert all(np.array_equal(a, b) for a, b in zip(got, ref)), (w, h)
        assert all(np.array_equal(a, b.reshape(a.shape)) for a, b in zip(luma, grey)), (w, h)


@pytest.mark.parametrize("case,match", [
    ("vp9-codec-id", "V_VP9"), ("avc-codec-id", "V_MPEG4/ISO/AVC"), ("laced", "laced"),
    ("content-encoding", "ContentEncoding"), ("two-video-tracks", "more than one video track"),
    ("not-matroska", "not a container")])
def test_refused_streams(clips, tmp_path, case, match):
    from fgvc_tpu_torch.data_io.video import VideoReader

    with VideoReader(clips["34x18"]) as src:
        packets, keys = src.packets(), src.keys
    kw = {"vp9-codec-id": dict(codec=b"V_VP9"), "avc-codec-id": dict(codec=b"V_MPEG4/ISO/AVC"),
          "laced": dict(lacing=True), "content-encoding": dict(encoding=True),
          "two-video-tracks": dict(video_tracks=2), "not-matroska": {}}[case]
    data = build_mkv(packets, keys, 34, 18, **kw)
    if case == "not-matroska":
        data = b"RIFF" + data[4:]
    with pytest.raises(ValueError, match=match):
        VideoReader(data)


@pytest.mark.parametrize("case,match", [("mp4v", r"'mp4v \(MPEG-4 Part 2\)'"), ("vp9", "'V_VP9'"),
                                        ("port-mjpeg", r"'mp4v \(JPEG\)'")])
def test_refused_codecs_by_name(tmp_path, case, match):
    """cv2's MPEG-4 Part 2 .mp4 (what the JAX tests write), cv2's VP9 .webm
    and the port's own Motion-JPEG .mp4, refused by those names until the
    port had decoders for them, now read under the names as cv2 reads them
    (tests/test_torch_port_video_mpeg4.py, tests/test_torch_port_video_vp9.py
    and tests/test_torch_port_video_avi_mjpeg.py hold the decoders to cv2 in
    full)."""
    from fgvc_tpu_torch.data_io.video import VideoReader
    from fgvc_tpu_torch.utils import visualize

    frames = clip_frames(48, 32, 4, seed=1)
    if case in ("mp4v", "vp9"):
        path = write_clip(tmp_path / f"c.{'mp4' if case == 'mp4v' else 'webm'}", frames,
                          "mp4v" if case == "mp4v" else "VP90")
    else:
        path = str(tmp_path / "c.mp4")
        visualize.save_video(frames[..., ::-1], path)
    ref, meta = cv2_read(path)
    with VideoReader(path) as reader:
        assert re.fullmatch(match, repr(reader.codec))
        got = list(reader)
        assert (reader.frame_count, reader.fps) == meta
    assert len(got) == len(ref) == 4
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def test_corrupt_packet_raises(clips):
    from fgvc_tpu_torch.data_io.video import VideoReader

    with open(clips["96x64"], "rb") as f:
        data = bytearray(f.read())
    with VideoReader(bytes(data)) as reader:
        first = int(reader.offsets[0])
    data[first + 3:first + 6] = b"\x00\x00\x00"  # the key frame's start code
    with VideoReader(bytes(data)) as reader, pytest.raises(ValueError, match="corrupt VP8"):
        reader.read()


# ---- the committed fixture --------------------------------------------

def fixture_record(path):
    """{frames, fps, count, sha256 of each frame} as cv2.VideoCapture reads it."""
    frames, (count, fps) = cv2_read(path)
    return {"width": int(frames[0].shape[1]), "height": int(frames[0].shape[0]),
            "frames": len(frames), "cv2_frame_count": count, "cv2_fps": fps,
            "sha256": [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]}


def test_fixture_json_is_cv2s():
    with open(FIXTURE_JSON) as f:
        pinned = json.load(f)
    assert os.path.getsize(FIXTURE) <= 1_500_000
    assert fixture_record(FIXTURE) == pinned
    assert (pinned["width"], pinned["height"], pinned["frames"]) == (640, 360, 250)


def test_fixture_decodes_to_pinned_digests():
    from fgvc_tpu_torch.data_io.video import VideoReader

    with open(FIXTURE_JSON) as f:
        pinned = json.load(f)
    with VideoReader(FIXTURE) as reader:
        digests = [hashlib.sha256(f.tobytes()).hexdigest() for f in reader]
        assert (reader.frame_count, reader.fps) == (pinned["cv2_frame_count"], pinned["cv2_fps"])
    assert digests == pinned["sha256"]


def fixture_frames(n=250, h=360, w=640, seed=0):
    """The fixture's content, RGB: a blurred noise backdrop panning slowly
    and four discs with a highlight moving across it (it compresses to
    about 1.3 MB at the 2 Mbit/s-like rate cv2's VP8 writer settles at;
    tools/data/generate_movi.py's textured scenes came to 2.5-3.2 MB, and
    cv2's FFmpeg writer takes no quality setting)."""
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.integers(0, 256, (12, 20, 3)).astype(np.uint8), (w + 200, h + 100),
                      interpolation=cv2.INTER_CUBIC)
    base = cv2.GaussianBlur(base, (0, 0), 6)
    discs = []
    for _ in range(4):
        r = int(rng.integers(25, 60))
        discs.append((r, rng.integers(30, 226, 3), rng.uniform([r, r], [w - r, h - r]),
                      rng.uniform(-3, 3, 2)))
    out = []
    for t in range(n):
        x0, y0 = int(100 + 90 * np.sin(t * 0.3 / 50)), int(50 + 40 * np.cos(t * 0.3 / 70))
        f = base[y0:y0 + h, x0:x0 + w].copy()
        for r, col, p, v in discs:
            c = np.abs(((p + v * t) % (2 * np.array([w, h]))) - np.array([w, h]))
            cv2.circle(f, (int(c[0]), int(c[1])), r, tuple(int(x) for x in col), -1,
                       lineType=cv2.LINE_AA)
            cv2.circle(f, (int(c[0] - r / 3), int(c[1] - r / 3)), r // 3,
                       tuple(int(min(255, x + 40)) for x in col), -1, lineType=cv2.LINE_AA)
        out.append(f)
    return np.stack(out)


if __name__ == "__main__":
    write_clip(FIXTURE, fixture_frames()[..., ::-1])
    with open(FIXTURE_JSON, "w") as f:
        json.dump(fixture_record(FIXTURE), f, indent=1)
    print(FIXTURE, os.path.getsize(FIXTURE), "bytes")
