"""Video files through the port's host library (csrc/fgpack.cpp), without
cv2, PyAV, decord or FFmpeg: what ``cv2.VideoCapture`` gives, for the files
the port decodes.

Read: VP8 in WebM/Matroska.  The demuxer yields the video track's packets
(SimpleBlock and BlockGroup, clusters of unknown size included); the VP8
decoder keeps one state across them (RFC 6386 key and inter frames, hidden
frames decoded and not shown); frames come out as swscale's unscaled YUV
4:2:0 -> BGR24 gives them to cv2 (its x86 SIMD arithmetic), so
``VideoReader.read`` equals ``cv2.VideoCapture.read`` bit for bit.

Refused with ValueError naming what was found: odd frame heights (cv2
converts them on swscale's scaling path, which is not reproduced), other
Matroska codecs
(``V_VP9``, ``V_MPEG4/ISO/AVC``, ...), MP4 files by their sample entry
(``mp4v``, ``avc1``, ...; the port's own Motion-JPEG ``.mp4`` too, whose
pixels FFmpeg's MJPEG decoder would give, not libjpeg's), laced blocks,
compressed or encrypted tracks, several video tracks, other containers.

    reader = VideoReader("clip.webm")
    reader.frame_count, reader.fps        # cv2's CAP_PROP_FRAME_COUNT / _FPS
    for bgr in reader: ...                # (H, W, 3) uint8, cv2.read's pixels
"""

from __future__ import annotations

import ctypes
import os
import struct
import time
from fractions import Fraction
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from fgvc_tpu_torch.data_io.fgpack import _load, _status, _u8p

EBML_MAGIC = b"\x1a\x45\xdf\xa3"
READ_CODECS = ("V_VP8",)
# the counters of fgpack_vp8_stats, in order
VP8_FEATURES = (
    "key_frames", "inter_frames", "hidden_frames", "intra_mbs_in_inter_frames",
    "bpred_mbs_in_inter_frames", "splitmv_mbs", "splitmv_4x4_mbs", "golden_mbs",
    "altref_mbs", "frames_with_lf_deltas", "frames_without_refresh_entropy_probs",
    "golden_updates", "altref_updates", "frames_with_sign_bias", "mbs_reading_past_edge",
    "frames_with_segmentation", "frames_without_refresh_last", "newmv_mbs", "nearmv_mbs",
    "nearestmv_mbs", "zeromv_mbs", "bilinear_frames", "simple_filter_frames",
    "unfiltered_frames",
)
# MPEG-4 systems object types (an esds's objectTypeIndication) of mp4v entries
_OBJECT_TYPES = {0x20: "MPEG-4 Part 2", 0x21: "H.264", 0x60: "MPEG-2", 0x61: "MPEG-2",
                 0x6A: "MPEG-1", 0x6C: "JPEG"}


def av_reduce(num: int, den: int, limit: int) -> Tuple[int, int]:
    """FFmpeg's av_reduce: the closest fraction to num / den with both terms
    at most `limit` (continued fractions)."""
    f = Fraction(num, den)
    num, den = f.numerator, f.denominator
    if num <= limit and den <= limit:
        return num, den
    a0, a1 = (0, 1), (1, 0)
    while den:
        x = num // den
        nxt = num - den * x
        a2 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
        if a2[0] > limit or a2[1] > limit:
            if a1[0]:
                x = (limit - a0[0]) // a1[0]
            if a1[1]:
                x = min(x, (limit - a0[1]) // a1[1])
            if den * (2 * x * a1[1] + a0[1]) > num * a1[1]:
                a1 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
            break
        a0, a1 = a1, a2
        num, den = den, nxt
    return a1


def _esds_object_type(data: bytes, at: int) -> Optional[int]:
    """The objectTypeIndication of the esds box whose type is at `at`: its
    ES_Descriptor (tag 3: ES_ID, flags and what they announce), then the
    DecoderConfigDescriptor (tag 4)."""
    def skip_size(p):
        while data[p] & 0x80:
            p += 1
        return p + 1

    if at < 0:
        return None
    p = at + 8  # past the type, version and flags
    if data[p] != 3:
        return None
    p = skip_size(p + 1)
    flags = data[p + 2]
    p += 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + data[p]
    if flags & 0x20:
        p += 2
    return data[skip_size(p + 1)] if data[p] == 4 else None


def mp4_video_codec(data: bytes) -> str:
    """The sample entry of an MP4's first video track (``'avc1'``,
    ``'mp4v (MPEG-4 Part 2)'``, ...), through utils/visualize.py's box
    walk; '?' where the boxes do not say."""
    from fgvc_tpu_torch.utils.visualize import _boxes, _child

    try:
        moov = _child(data, 0, len(data), [b"moov"])
        for kind, a, b in _boxes(data, *moov):
            if kind != b"trak":
                continue
            mdia = _child(data, a, b, [b"mdia"])
            ha, _ = _child(data, *mdia, [b"hdlr"])
            if data[ha + 8:ha + 12] != b"vide":
                continue
            sa, _ = _child(data, *_child(data, *mdia, [b"minf", b"stbl"]), [b"stsd"])
            entry, ea, eb = next(_boxes(data, sa + 8, len(data)))
            name = entry.decode("latin-1")
            oti = _esds_object_type(data, data.find(b"esds", ea, eb)) if entry == b"mp4v" else None
            if oti is not None:
                name += f" ({_OBJECT_TYPES.get(oti, f'object type 0x{oti:02x}')})"
            return name
    except (ValueError, StopIteration, struct.error, IndexError):
        pass
    return "?"


class VideoReader:
    """The frames of one video file (a path or its bytes), in order, as
    cv2.VideoCapture.read gives them: (H, W, 3) uint8 BGR.

    frame_count and fps are cv2's CAP_PROP_FRAME_COUNT and CAP_PROP_FPS:
    the fps is FFmpeg's avg_frame_rate from the track's DefaultDuration
    (av_reduce to terms of at most 30000), the count the container's
    duration times the fps rounded (OpenCV's get_total_frames; WebM stores
    no frame count), and the number of packets where the file has no
    Duration.  `timings` accumulates seconds spent demuxing (once the file
    is in memory), decoding and converting.  Unsupported files raise
    ValueError naming the codec."""

    def __init__(self, src: Union[str, os.PathLike, bytes]):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self.data, self.name = bytes(src), "video bytes"
        else:
            with open(src, "rb") as f:
                self.data, self.name = f.read(), str(src)
        self._lib = _load()  # the library's first use builds it: not demuxing
        self._dec = None
        t0 = time.perf_counter()
        if self.data[4:8] == b"ftyp":
            raise ValueError(
                f"{self.name}: MP4 video codec {mp4_video_codec(self.data)!r} is not decoded "
                f"by the port (it reads {', '.join(READ_CODECS)} in WebM/Matroska)")
        if self.data[:4] != EBML_MAGIC:
            raise ValueError(f"{self.name}: not a container the port reads "
                             "(WebM/Matroska; MP4 files are recognised and refused)")
        status = ctypes.c_int()
        handle = self._lib.fgpack_webm_open(self.data, len(self.data), ctypes.byref(status))
        if not handle:
            raise ValueError(f"{self.name}: {_status(status.value)}")
        try:
            info = (ctypes.c_int64 * 5)()
            duration = ctypes.c_double()
            codec = ctypes.create_string_buffer(64)
            self._lib.fgpack_webm_info(handle, info, ctypes.byref(duration), codec, 64)
            self.codec = codec.value.decode("latin-1")
            if status.value != 0:
                raise ValueError(
                    f"{self.name}: {_status(status.value)} (video codec {self.codec!r})")
            if self.codec not in READ_CODECS:
                raise ValueError(f"{self.name}: video codec {self.codec!r} is not decoded by "
                                 f"the port (it reads {', '.join(READ_CODECS)} in WebM/Matroska)")
            self.width, self.height, n = int(info[0]), int(info[1]), int(info[2])
            default_duration, scale = int(info[3]), int(info[4])
            self.offsets = np.zeros(n, np.int64)
            self.sizes = np.zeros(n, np.int64)
            self.pts = np.zeros(n, np.int64)
            self.keys = np.zeros(n, np.uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            self._lib.fgpack_webm_packets(handle, self.offsets.ctypes.data_as(i64p),
                                          self.sizes.ctypes.data_as(i64p),
                                          self.pts.ctypes.data_as(i64p), _u8p(self.keys))
        finally:
            self._lib.fgpack_webm_close(handle)
        if n and not self.data[self.offsets[0]] & 1 and self.sizes[0] >= 10:
            # the stream's size is its first key frame's (later key frames
            # may not change it)
            at = int(self.offsets[0])
            height = int.from_bytes(self.data[at + 8:at + 10], "little") & 0x3FFF
            if height % 2:
                raise ValueError(
                    f"{self.name}: odd frame height {height}: cv2 converts such frames on "
                    "swscale's scaling path (bicubic chroma), which the port does not "
                    "reproduce")
        if default_duration > 0:
            num, den = av_reduce(1_000_000_000, default_duration, 30000)
            self.fps = num / den
        elif n > 1 and self.pts[-1] > self.pts[0]:
            self.fps = (n - 1) * 1e9 / float(self.pts[-1] - self.pts[0])
        else:
            self.fps = 0.0
        if duration.value > 0 and self.fps > 0:
            # matroskadec: Duration * TimecodeScale * 1000 / AV_TIME_BASE,
            # truncated to microseconds; OpenCV rounds seconds * fps
            micros = int(duration.value * scale * 1000 / 1_000_000)
            self.frame_count = int(np.floor(micros / 1_000_000 * self.fps + 0.5))
        else:
            self.frame_count = n
        self._dec = self._lib.fgpack_vp8_new()
        self._next = 0
        self._out = (ctypes.c_int64 * 4)()
        self.timings = {"demux": time.perf_counter() - t0, "decode": 0.0, "convert": 0.0}

    def packets(self) -> List[bytes]:
        """The video track's packets in file order (cv2's CAP_PROP_FORMAT = -1)."""
        return [self.data[o:o + s] for o, s in zip(self.offsets, self.sizes)]

    def _decode_next(self) -> bool:
        """Decode packets up to the next shown frame; False at the end."""
        while self._next < len(self.sizes):
            o, s = int(self.offsets[self._next]), int(self.sizes[self._next])
            self._next += 1
            t0 = time.perf_counter()
            rc = self._lib.fgpack_vp8_decode(self._dec, self.data[o:o + s], s, self._out)
            self.timings["decode"] += time.perf_counter() - t0
            if rc != 0:
                raise ValueError(f"{self.name}: packet {self._next - 1}: {_status(rc)}")
            if self._out[0]:
                return True
        return False

    def read(self) -> Optional[np.ndarray]:
        """The next shown frame as (H, W, 3) uint8 BGR, None at the end."""
        if self._dec is None or not self._decode_next():
            return None
        h, w = int(self._out[2]), int(self._out[1])
        t0 = time.perf_counter()
        frame = np.empty((h, w, 3), np.uint8)
        self._lib.fgpack_vp8_bgr(self._dec, _u8p(frame))
        self.timings["convert"] += time.perf_counter() - t0
        return frame

    def planes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The last decoded frame's Y (H, W), U and V ((H + 1) // 2,
        (W + 1) // 2) planes; Y is what cv2 returns with
        CAP_PROP_CONVERT_RGB = 0."""
        h, w = int(self._out[2]), int(self._out[1])
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        if self._dec is None or self._lib.fgpack_vp8_planes(self._dec, _u8p(y), _u8p(u),
                                                            _u8p(v)) != 0:
            raise ValueError(f"{self.name}: no decoded frame")
        return y, u, v

    def features(self) -> Dict[str, int]:
        """How many frames or macroblocks so far used each VP8 feature
        (VP8_FEATURES)."""
        out = (ctypes.c_int64 * len(VP8_FEATURES))()
        self._lib.fgpack_vp8_stats(self._dec, out, len(VP8_FEATURES))
        return dict(zip(VP8_FEATURES, (int(v) for v in out)))

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def close(self) -> None:
        if self._dec:
            self._lib.fgpack_vp8_free(self._dec)
            self._dec = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
