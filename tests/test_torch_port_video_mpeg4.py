"""The port's MPEG-4 Part 2 reader (fgvc_tpu_torch/data_io/video.py over
csrc/mpeg4video.cpp's MP4 demuxer and decoder and fgpack.cpp's swscale
YUV -> BGR) against cv2.VideoCapture on clips that cv2.VideoWriter writes
here with its 'mp4v' fourcc (what the JAX package's save_video and video
tests write): packets byte for byte (CAP_PROP_FORMAT = -1), the luma plane
against CAP_PROP_CONVERT_RGB = 0, every BGR frame bit for bit, the frame
count and rate; MP4 forms cv2's writer does not make (co64, stz2, several
chunks, a QuickTime file without ftyp, edit lists) on files built here from
its samples; an odd width (the VOL rewritten) equal to cv2 and an odd
height refused; the committed 640 x 360 fixture against its digests; the
JAX package's own video stages, demo loader, run_task('kinetics',
annotations=) and save_video output against the port's.  Seeded numpy
content: panning smooth noise with a moving disc and box, a static scene,
and per-frame noise.

    python tests/test_torch_port_video_mpeg4.py   # remakes the fixture and its JSON
"""

import dataclasses
import hashlib
import json
import os
import struct

import numpy as np
import pytest
import torch

import test_torch_port_video_codec as codec

cv2 = pytest.importorskip("cv2")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_port_fixtures", "mp4v_640x360_250f.mp4")
FIXTURE_JSON = os.path.join(HERE, "torch_port_fixtures", "mp4v_640x360_250f.json")
# name -> (width, height, frames, content): cv2's 12-frame GOPs, the JAX
# tests' sizes and widths that are not multiples of 16
CLIPS = {"640x360-pan": (640, 360, 26, "pan"), "96x64-pan": (96, 64, 30, "pan"),
         "96x64-static": (96, 64, 26, "static"), "96x64-noise": (96, 64, 26, "noise"),
         "48x48-pan": (48, 48, 26, "pan"), "32x24-pan": (32, 24, 26, "pan"),
         "100x60-pan": (100, 60, 26, "pan"), "90x54-noise": (90, 54, 25, "noise")}
H = W = 32
T = 13


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """torch on two threads here, as in every port test module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def content(kind, w, h, n, seed):
    """(n, h, w, 3) uint8 BGR: 'pan' (codec.clip_frames), 'static' (a still
    textured scene with one small disc moving) or 'noise' (the pan with
    fresh noise of +-24 in every frame)."""
    if kind == "static":
        still = codec.clip_frames(w, h, 1, seed=seed)[0]
        out = []
        for i in range(n):
            f = still.copy()
            cv2.circle(f, (int(w / 4 + i * w / (2 * n)), h // 2), max(3, h // 8), (40, 220, 90), -1)
            out.append(f)
        return np.stack(out)
    frames = codec.clip_frames(w, h, n, seed=seed)
    if kind == "noise":
        rng = np.random.default_rng(seed)
        frames = np.clip(frames.astype(np.int16) + rng.integers(-24, 25, frames.shape), 0,
                         255).astype(np.uint8)
    return frames


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    base = tmp_path_factory.mktemp("mp4v")
    return {name: codec.write_clip(base / f"{name}.mp4", content(kind, w, h, n, seed=w + n),
                                   "mp4v")
            for name, (w, h, n, kind) in CLIPS.items()}


def reference(path):
    """cv2's frames, packets, grey planes, count and fps of a file."""
    frames, meta = codec.cv2_read(path)
    raw, _ = codec.cv2_read(path, raw=True)
    grey, _ = codec.cv2_read(path, convert_rgb=False)
    return frames, raw, grey, meta


def assert_reads_as_cv2(path, expect_frames=None):
    """VideoReader of `path` against cv2: packets, every frame, its luma,
    count and fps; returns the reader's features."""
    from fgvc_tpu_torch.data_io.video import MPEG4_PART2, VideoReader

    ref, raw, grey, meta = reference(path)
    with VideoReader(path) as reader:
        assert reader.codec == MPEG4_PART2
        assert reader.packets() == raw
        got = 0
        for t, frame in enumerate(reader):
            assert frame.shape == ref[t].shape and frame.dtype == np.uint8
            assert np.array_equal(frame, ref[t]), (path, t, int(np.abs(
                frame.astype(int) - ref[t]).max()))
            y, u, v = reader.planes()
            assert np.array_equal(y, grey[t].reshape(y.shape)), (path, t)
            assert u.shape == v.shape == ((y.shape[0] + 1) // 2, (y.shape[1] + 1) // 2)
            got += 1
        assert (reader.frame_count, reader.fps) == meta
        feats = reader.features()
    assert got == len(ref) == (expect_frames if expect_frames is not None else len(ref))
    return feats


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_frames_equal_cv2(clips, name):
    """Every frame bit for bit as cv2.VideoCapture.read gives it, the luma
    plane as CAP_PROP_CONVERT_RGB = 0 gives it, the packets as
    CAP_PROP_FORMAT = -1 gives them (cv2 keeps the esds headers apart), and
    CAP_PROP_FRAME_COUNT / CAP_PROP_FPS."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    w, h, n, _ = CLIPS[name]
    assert_reads_as_cv2(clips[name], expect_frames=n)
    with VideoReader(clips[name]) as reader:
        assert (reader.width, reader.height) == (w, h)
        # stss: the I-VOPs (every 12th, cv2's GOP), the esds: VOS, VO, VOL
        vop_types = [p[p.find(b"\x00\x00\x01\xb6") + 4] >> 6 for p in reader.packets()]
        assert list(reader.keys) == [int(t == 0) for t in vop_types]
        assert reader.keys.sum() >= 3 and reader.dsi.startswith(b"\x00\x00\x01\xb0")


@pytest.mark.parametrize("fps", [10.0, 24.0, 25.0, 30000 / 1001, 12.5])
def test_rate_and_count_equal_cv2(tmp_path, fps):
    from fgvc_tpu_torch.data_io.video import VideoReader

    path = codec.write_clip(tmp_path / "r.mp4", codec.clip_frames(48, 32, 23, seed=3), "mp4v",
                            fps=fps)
    _, meta = codec.cv2_read(path)
    with VideoReader(path) as reader:
        assert (reader.frame_count, reader.fps) == meta
        assert len(list(reader)) == 23


def test_mpeg4_features_exercised(clips):
    """cv2's writer reaches I- and P-VOPs, both rounding types, intra
    macroblocks inside P-VOPs, skipped macroblocks and vectors that read
    past the frame's edge; the counts are printed for the record (the other
    tools come from libavcodec's encoder in
    tests/test_torch_port_video_libavcodec.py)."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    total = {}
    for name in sorted(CLIPS):
        with VideoReader(clips[name]) as reader:
            for _ in reader:
                pass
            for k, v in reader.features().items():
                total[k] = total.get(k, 0) + v
    print("MPEG-4 Part 2 features over cv2's clips:", json.dumps(total))
    for key in ("i_vops", "p_vops", "rounding_type_1_vops", "intra_mbs", "intra_mbs_in_p_vops",
                "inter_mbs", "skipped_mbs", "mbs_reading_past_edge", "escape3_coefficients"):
        assert total[key] > 0, key
    assert total["b_vops"] == total["video_packets"] == total["mpeg_quant_vops"] == 0


# ---- MP4 files built here --------------------------------------------------

def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full(kind: bytes, payload: bytes, version=0, flags=0) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + payload)


def _descr(tag: int, payload: bytes) -> bytes:
    n = len(payload)
    size = bytes([n]) if n < 128 else bytes([0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                                             0x80 | (n >> 7) & 0x7F, n & 0x7F])
    return bytes([tag]) + size + payload


def build_mp4(samples, dsi, w, h, timescale=25, durations=None, cts=None, keys=None,
              per_chunk=(1 << 30,), co64=False, stz2=False, elst=None, ftyp=True,
              object_type=0x20):
    """An MP4 of mp4v samples (one video track): `durations` per sample
    (stts, run-length coded), composition offsets `cts` (ctts) and `keys`
    (stss) where given, chunks of `per_chunk` samples (stsc runs cycle
    through the tuple), co64 / stz2 in place of stco / stsz, no
    DecoderSpecificInfo where `dsi` is empty (the VOL in band), an edit list
    of (segment duration, media time) entries, and a QuickTime-style file
    without ftyp (mdat first)."""
    n = len(samples)
    durations = list(durations or [1] * n)
    counts = []
    k = 0
    while k < n:
        c = min(per_chunk[len(counts) % len(per_chunk)], n - k)
        counts.append(c)
        k += c
    head = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41") if ftyp else b""
    mdat_start = len(head) + 16
    offsets, pos = [], mdat_start
    for c, i0 in zip(counts, np.cumsum([0] + counts[:-1])):
        offsets.append(pos)
        pos += sum(len(s) for s in samples[i0:i0 + c])
    mdat = struct.pack(">I", 1) + b"mdat" + struct.pack(">Q", 16 + sum(map(len, samples)))
    mdat += b"".join(samples)
    total = sum(durations)
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    mvhd = _full(b"mvhd", struct.pack(">IIII", 0, 0, 1000, total * 1000 // timescale)
                 + struct.pack(">IH", 0x10000, 0x100) + bytes(10) + matrix + bytes(24)
                 + struct.pack(">I", 2))
    tkhd = _full(b"tkhd", struct.pack(">IIIII", 0, 0, 1, 0, total * 1000 // timescale)
                 + bytes(8) + struct.pack(">HHHH", 0, 0, 0, 0) + matrix
                 + struct.pack(">II", w << 16, h << 16), flags=3)
    esds = _full(b"esds", _descr(3, struct.pack(">HB", 1, 0) + _descr(
        4, bytes([object_type, 0x11]) + bytes(3) + struct.pack(">II", 0, 0)
        + (_descr(5, dsi) if dsi else b"")) + _descr(6, b"\x02")))
    entry = _box(b"mp4v", bytes(6) + struct.pack(">H", 1) + bytes(16)
                 + struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1) + bytes(32)
                 + struct.pack(">Hh", 0x18, -1) + esds)
    runs = []
    for d in durations:
        if runs and runs[-1][1] == d:
            runs[-1][0] += 1
        else:
            runs.append([1, d])
    stbl = _full(b"stsd", struct.pack(">I", 1) + entry)
    stbl += _full(b"stts", struct.pack(">I", len(runs)) + b"".join(struct.pack(">II", *r)
                                                                      for r in runs))
    if cts is not None:
        stbl += _full(b"ctts", struct.pack(">I", n) + b"".join(struct.pack(">Ii", 1, c)
                                                                 for c in cts))
    if keys is not None:
        idx = [i + 1 for i, key in enumerate(keys) if key]
        stbl += _full(b"stss", struct.pack(">I", len(idx)) + b"".join(struct.pack(">I", i)
                                                                        for i in idx))
    stsc = []
    for i, c in enumerate(counts):
        if not stsc or stsc[-1][1] != c:
            stsc.append((i + 1, c, 1))
    stbl += _full(b"stsc", struct.pack(">I", len(stsc)) + b"".join(struct.pack(">III", *e)
                                                                     for e in stsc))
    if stz2:
        stbl += _full(b"stz2", struct.pack(">II", 16, n) + b"".join(struct.pack(">H", len(s))
                                                                     for s in samples))
    else:
        stbl += _full(b"stsz", struct.pack(">II", 0, n) + b"".join(struct.pack(">I", len(s))
                                                                    for s in samples))
    if co64:
        stbl += _full(b"co64", struct.pack(">I", len(offsets)) + b"".join(
            struct.pack(">Q", o) for o in offsets))
    else:
        stbl += _full(b"stco", struct.pack(">I", len(offsets)) + b"".join(
            struct.pack(">I", o) for o in offsets))
    minf = _box(b"minf", _full(b"vmhd", bytes(8), flags=1)
                + _box(b"dinf", _full(b"dref", struct.pack(">I", 1) + _full(b"url ", b"", flags=1)))
                + _box(b"stbl", stbl))
    mdia = _box(b"mdia", _full(b"mdhd", struct.pack(">IIIIHH", 0, 0, timescale, total, 0x55C4, 0))
                + _full(b"hdlr", bytes(4) + b"vide" + bytes(12) + b"VideoHandler\x00") + minf)
    edts = b""
    if elst is not None:
        edts = _box(b"edts", _full(b"elst", struct.pack(">I", len(elst)) + b"".join(
            struct.pack(">IiI", d * 1000 // timescale, m, 0x10000) for d, m in elst)))
    moov = _box(b"moov", mvhd + _box(b"trak", tkhd + edts + mdia))
    return head + mdat + moov


@pytest.mark.parametrize("form", ["co64-stz2-chunks", "quicktime-no-ftyp", "edit-list",
                                  "stts-runs"])
def test_mp4_forms_equal_cv2(clips, tmp_path, form):
    """Files built from cv2's samples in forms its writer does not make:
    64-bit chunk offsets, 16-bit compact sizes and chunk runs of 3, 1 and 5
    samples; mdat before moov without ftyp; an edit list with an empty edit
    before the media; stts runs of two durations (the rate cv2 reports
    follows them).  Each reads as cv2 reads it."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    with VideoReader(clips["96x64-pan"]) as src:
        samples, dsi, keys = src.packets(), src.dsi, src.keys
    kw = {"co64-stz2-chunks": dict(co64=True, stz2=True, per_chunk=(3, 1, 5), keys=keys),
          "quicktime-no-ftyp": dict(ftyp=False, keys=keys),
          "edit-list": dict(elst=[(2, -1), (len(samples), 0)], keys=keys),
          "stts-runs": dict(durations=[2] * 10 + [3] * (len(samples) - 10), timescale=50)}[form]
    path = tmp_path / "built.mp4"
    path.write_bytes(build_mp4(samples, dsi, 96, 64, **kw))
    assert_reads_as_cv2(str(path), expect_frames=len(samples))


def test_edit_list_dropping_samples_is_refused(clips):
    """An edit whose media starts after the first sample would make FFmpeg
    drop frames; the port refuses it by name rather than guess."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    with VideoReader(clips["48x48-pan"]) as src:
        samples, dsi = src.packets(), src.dsi
    with pytest.raises(ValueError, match="edit list"):
        VideoReader(build_mp4(samples, dsi, 48, 48, elst=[(len(samples) - 2, 2)]))


# ---- the VOL rewritten ------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self):
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def vol_fields(header: bytes):
    """Bit offsets (from the VOL start code's end) of the fields of a
    Simple/Advanced Simple VOL: width, height, interlaced, sprite_enable,
    quant_type, data_partitioned (where no matrix is loaded), and the VOL's
    end (the next start code)."""
    at = header.find(b"\x00\x00\x01\x20")
    bits = "".join(f"{b:08b}" for b in header[at + 4:])
    p, out = 1, {}
    vo_type = int(bits[p:p + 8], 2)
    p += 8
    ver = 1
    if bits[p] == "1":
        ver = int(bits[p + 1:p + 5], 2)
        p += 8
    else:
        p += 1
    if int(bits[p:p + 4], 2) == 15:
        p += 16
    p += 4
    if bits[p] == "1":
        p += 4
        if bits[p] == "1":
            p += 79
        p += 1
    else:
        p += 1
    p += 2 + 1  # shape, marker
    res = int(bits[p:p + 16], 2)
    p += 16 + 1
    tbits = max(1, (res - 1).bit_length())
    p += 1 + (tbits if bits[p] == "1" else 0)
    p += 1
    out["width"] = p
    p += 13 + 1
    out["height"] = p
    p += 13 + 1
    out["interlaced"] = p
    p += 2  # interlaced, obmc_disable
    out["sprite_enable"] = p
    p += 1 if ver == 1 else 2
    p += 1  # not_8_bit
    out["quant_type"] = p
    p += 3 if bits[p] == "1" else 1  # quant_type (and two default-matrix flags)
    p += 1 if ver != 1 else 0  # quarter_sample
    p += 2  # complexity_estimation_disable, resync_marker_disable
    out["data_partitioned"] = p
    out["vo_type"], out["ver"] = vo_type, ver
    out["end"] = (header.find(b"\x00\x00\x01", at + 4) - at - 4) * 8
    return at + 4, bits, out


def rewrite_vol(header: bytes, edit) -> bytes:
    """The header bytes with the VOL's bits passed through `edit(bits,
    fields) -> bits` (a string of '0'/'1' up to the next start code) and
    re-stuffed to a byte boundary."""
    start, bits, fields = vol_fields(header)
    body = bits[:fields["end"]].rstrip("1")
    body = body[:-1] if body.endswith("0") else body  # the stuffing: '0' then '1's
    body = edit(body, fields)
    body += "0" + "1" * (-(len(body) + 1) % 8)
    new = int(body, 2).to_bytes(len(body) // 8, "big")
    return header[:start] + new + header[start + fields["end"] // 8:]


def test_odd_width_equals_cv2_and_odd_height_is_refused(clips, tmp_path):
    """A VOL width of 97 on 100 x 60's macroblocks decodes and converts on
    swscale's unscaled path equal to cv2; an odd height (VOL 100 x 59) is
    refused by name, as for VP8."""
    from fgvc_tpu_torch.data_io.video import VideoReader

    with VideoReader(clips["100x60-pan"]) as src:
        samples, dsi = src.packets(), src.dsi

    def size(w, h):
        def edit(bits, f):
            bits = bits[:f["width"]] + f"{w:013b}" + bits[f["width"] + 13:]
            return bits[:f["height"]] + f"{h:013b}" + bits[f["height"] + 13:]
        return rewrite_vol(dsi, edit)

    path = tmp_path / "odd.mp4"
    path.write_bytes(build_mp4(samples, size(97, 60), 97, 60))
    assert_reads_as_cv2(str(path), expect_frames=len(samples))
    with pytest.raises(ValueError, match="odd frame height 59"):
        VideoReader(build_mp4(samples, size(100, 59), 100, 59))


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
        digests = [hashlib.sha256(f.tobytes()).hexdigest() for f in reader]
        assert (reader.frame_count, reader.fps) == (pinned["cv2_frame_count"], pinned["cv2_fps"])
        assert reader.features()["i_vops"] == 21
    assert digests == pinned["sha256"]


# ---- the JAX package's video path over mp4v clips ---------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import test_torch_port_eval_data as data
    import test_torch_port_video_pipeline as pipeline

    base = tmp_path_factory.mktemp("mp4v_pipeline")
    clips = base / "clips"
    clips.mkdir()
    for i, vid in enumerate(("clip_a", "clip_b")):
        codec.write_clip(clips / f"{vid}.mp4", codec.clip_frames(48, 40, T, seed=30 + i), "mp4v")
    return {"clips": str(clips), "clip": str(clips / "clip_a.mp4"), "base": base,
            "csv": pipeline.write_csv(base / "ann.csv", ("clip_a", "clip_b"), seed=4),
            "pth": data.export_pth(base / "weights.pth", (H, W))}


def test_stages_and_demo_loader_equal_jax(tree):
    """VideoInit's count, VideoDecode of picked indices (past the end too),
    decode_video with and without a resize and the demo's load_video, as
    the JAX functions give them through cv2."""
    import fgvc_tpu.datasets.video_decode as jax_vd
    import fgvc_tpu_torch.datasets.video_decode as vd
    from fgvc_tpu.cli.demo import load_video as jax_load_video
    from fgvc_tpu_torch.cli.demo import load_video

    a = vd.VideoInit()({"filename": tree["clip"]})
    assert a == jax_vd.VideoInit()({"filename": tree["clip"]}) and a["total_frames"] == T
    inds = np.array([0, 5, 5, 12, 7, T, T + 2])
    a = vd.VideoDecode()({"filename": tree["clip"], "frame_inds": inds})
    b = jax_vd.VideoDecode()({"filename": tree["clip"], "frame_inds": inds})
    assert a.keys() == b.keys()
    for x, y in zip(a["imgs"], b["imgs"]):
        np.testing.assert_array_equal(x, y)
    for resize in (None, (24, 20), (64, 50)):
        np.testing.assert_array_equal(vd.decode_video(tree["clip"], resize=resize),
                                      jax_vd.decode_video(tree["clip"], resize=resize))
    for stride, max_frames in ((1, 0), (3, 2)):
        np.testing.assert_array_equal(
            load_video(tree["clip"], 32, stride=stride, max_frames=max_frames),
            jax_load_video(tree["clip"], 32, stride=stride, max_frames=max_frames))


@pytest.mark.parametrize("query_mode", ["first", "strided"])
def test_run_task_annotations_matches_jax(tree, query_mode):
    """run_task('kinetics', annotations=CSV) over mp4v clips within 1e-6 of
    the JAX harness (which decodes them with cv2) on the same weights."""
    from fgvc_tpu.apis.test import TASK_CONFIGS as JAX_TASK_CONFIGS
    from fgvc_tpu.apis.test import run_task as jax_run_task
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, run_task

    small = dict(neighbor_range=8, tile=8, input_size=(H, W))
    jax_cfg = dataclasses.replace(JAX_TASK_CONFIGS["kinetics"], **small, frame_bucket=8,
                                  point_bucket=4, attention_impl="pallas")
    ref = jax_run_task("kinetics", tree["clips"], checkpoint=tree["pth"], test_cfg=jax_cfg,
                       query_mode=query_mode, annotations=tree["csv"])
    out = run_task("kinetics", tree["clips"], checkpoint=tree["pth"], device="cpu",
                   test_cfg=dataclasses.replace(TASK_CONFIGS["kinetics"], **small),
                   query_mode=query_mode, annotations=tree["csv"])
    shared = sorted(set(ref) & set(out))
    assert "average_pts_within_thresh" in shared and "average_jaccard" in shared
    for k in shared:
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_jax_save_video_reads_equal_cv2(tmp_path):
    """What the JAX package's save_video writes (cv2's 'mp4v' at 24 fps),
    read by the port as cv2 reads it."""
    from fgvc_tpu.utils.visualize import save_video

    path = str(tmp_path / "jax_demo.mp4")
    save_video(codec.clip_frames(64, 48, 14, seed=8)[..., ::-1], path)
    assert_reads_as_cv2(path, expect_frames=14)


def fixture_frames(n=250, h=360, w=640, seed=1):
    """The fixture's content: test_torch_port_video_codec.fixture_frames
    with another seed (a panning backdrop and four moving discs), which cv2's
    mp4v writer codes to about 0.78 MB in 21 GOPs of 12."""
    return codec.fixture_frames(n, h, w, seed=seed)


if __name__ == "__main__":
    codec.write_clip(FIXTURE, fixture_frames()[..., ::-1], "mp4v")
    with open(FIXTURE_JSON, "w") as f:
        json.dump(codec.fixture_record(FIXTURE), f, indent=1)
    print(FIXTURE, os.path.getsize(FIXTURE), "bytes")
