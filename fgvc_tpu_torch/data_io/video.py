"""Video files through the port's host library (csrc/fgpack.cpp,
csrc/mpeg4video.cpp, csrc/vp9video.cpp, csrc/mjpeg.cpp, csrc/avi.cpp and
csrc/gif.cpp), without cv2, PyAV, decord or FFmpeg: what
``cv2.VideoCapture`` gives, for the files the port decodes.

Read: VP8 and VP9 (profile 0: 8-bit 4:2:0, what YouTube-style .webm/.mkv
clips and cv2.VideoWriter's 'VP90' fourcc carry) in WebM/Matroska; MPEG-4
Part 2 (``mp4v``, what cv2.VideoWriter's 'mp4v' fourcc writes) in MP4/MOV,
and in AVI under the fourccs XVID, DIVX, DX50, FMP4 and MP4V (either case:
what cv2.VideoWriter's 'XVID', 'DIVX', 'FMP4' and 'mp4v' write to .avi);
Motion-JPEG in AVI ('MJPG'), in MP4/MOV (an ``mp4v`` entry whose esds
names JPEG: cv2's 'MJPG' in .mp4, and the port's own
utils/visualize.save_video) and in Matroska (``V_MJPEG``); GIF87a and
GIF89a (PIL's and save_video's .gif among them: FFmpeg's gif decoder's
BGRA canvas with the alpha dropped, data_io/gif.py).  The WebM
demuxer yields the video track's packets (SimpleBlock and BlockGroup,
clusters of unknown size included); the MP4 demuxer the first video
track's samples (stsz/stz2, stco/co64, stsc runs, stts, ctts, stss; an edit
list only where it drops no sample) and its esds headers; the AVI demuxer
the video stream's chunks in idx1's order (or movi's without one) and
strf's extradata.  The VP8 decoder keeps one state across packets (RFC 6386
key and inter frames, hidden frames decoded and not shown); the VP9
decoder's planes equal libvpx's (superframes with hidden alt-ref frames,
show_existing_frame, compound prediction, tiles, segmentation, lossless,
the interpolation filters, backward adaptation, error-resilient and
frame-parallel streams); the MPEG-4 Part 2 decoder decodes Simple and
Advanced Simple I-, P- and B-VOPs as FFmpeg's mpeg4 decoder does (4MV,
quarter-pel, resync markers, data partitioning, H.263 and MPEG
quantisation, B-VOPs in display order; XviD's IDCT and FFmpeg's
workarounds for XviD- and DivX-signed streams, and for unsigned ones in AVI
under an XviD or DivX fourcc; VOL headers in band or in extradata); the
Motion-JPEG decoder's planes equal FFmpeg's mjpeg decoder's (baseline and
extended Huffman frames sampled 4:2:0, 4:2:2 or 4:4:4, restart intervals,
frames without DHT by the standard tables, FFmpeg's simple IDCT).  Frames
come out as swscale converts them for cv2 (csrc/swscale.cpp; for VP9 with
the coefficients of the colour space and range the stream carries, for
Motion-JPEG full-range BT.601): 4:2:0 and 4:2:2 at an even height by its
unscaled YUV -> BGR24 (its x86 SIMD arithmetic), 4:4:4 and odd heights by
its scaling path at scale 1 (bicubic chroma, its x86 and C output
stages), so ``VideoReader.read`` equals ``cv2.VideoCapture.read`` bit for
bit at any frame size (a GIF's frames too).  What the files state of colour
is read as cv2's FFmpeg reads it: a Matroska track's chroma siting (VP8 and
VP9), an MP4 sample entry's colr colour space and range (mp4v), an MPEG-4
Part 2 visual object's colour description over it.

Refused with ValueError naming what was found: other codecs
(``V_MPEG4/ISO/AVC``, ``avc1``, an AVI's ``H264`` or raw ``I420``, MP4 JPEG
sample entries other than mp4v's, ...), VP9 forms the decoder
does not decode (profiles 1-3, a frame size that changes mid-stream,
intra-only frames, the reserved colour space), MPEG-4 Part 2 tools the
decoder does not decode (interlaced VOPs, sprites and GMC, shape coding,
N-bit, scalability, reversible VLC, NEWPRED, reduced resolution, packed
DivX B-frames, streams signed by an old libavcodec), Motion-JPEG forms it
does not decode (progressive, arithmetic-coded, lossless, hierarchical,
12-bit, greyscale, CMYK/YCCK, RGB, other samplings, interlaced fields),
primaries or a transfer curve that swscale colour-manages (a Matroska
Colour element's, an MP4 colr box's, an MPEG-4 Part 2 colour
description's: wide gamuts, log, PQ, HLG), colour spaces swscale has no
coefficients for or that the port does not convert (FCC, YCgCo, BT.2020
constant luminance), laced Matroska blocks, compressed or encrypted
tracks, several Matroska video tracks or AVI video streams, MP4 edit lists
that drop samples,
OpenDML AVIX continuations, GIF forms FFmpeg would not decode whole (an
image past the screen's edge or without a colour table, a minimum code
size outside 1 to 11, LZW data running past its sub-blocks), other
containers.

    reader = VideoReader("clip.webm")     # VP8 or VP9; an mp4v .mp4; an .avi; a .gif
    reader.frame_count, reader.fps        # cv2's CAP_PROP_FRAME_COUNT / _FPS
    for bgr in reader: ...                # (H, W, 3) uint8, cv2.read's pixels
"""

from __future__ import annotations

import ctypes
import os
import time
from fractions import Fraction
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from fgvc_tpu_torch.data_io.fgpack import _load, _status, _u8p
from fgvc_tpu_torch.data_io.gif import is_gif, read_container

EBML_MAGIC = b"\x1a\x45\xdf\xa3"
# the first box types of the ISO-BMFF files the MP4 demuxer opens
MP4_BOXES = (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip")
MPEG4_PART2 = "mp4v (MPEG-4 Part 2)"
MP4_JPEG = "mp4v (JPEG)"
# AVI fourccs read (compared upper-cased, as FFmpeg's riff tags match
# them) -> the decoder's kind
AVI_TAGS = {"XVID": "mpeg4", "DIVX": "mpeg4", "DX50": "mpeg4", "FMP4": "mpeg4", "MP4V": "mpeg4",
            "MJPG": "mjpeg"}
_AVI_CODECS = {"mpeg4": "MPEG-4 Part 2", "mjpeg": "Motion-JPEG"}
READ_CODECS = ("V_VP8", "V_VP9", "V_MJPEG", MPEG4_PART2, MP4_JPEG,
               *(f"{t} ({_AVI_CODECS[k]})" for t, k in AVI_TAGS.items()), "gif")
READS = ("VP8, VP9 and Motion-JPEG in WebM/Matroska, MPEG-4 Part 2 and Motion-JPEG in "
         "MP4/MOV and AVI, and GIF")
# the WebM, MP4 and GIF codec names -> the decoder's kind (an AVI's from AVI_TAGS)
_KINDS = {"V_VP8": "vp8", "V_VP9": "vp9", "V_MJPEG": "mjpeg", MPEG4_PART2: "mpeg4",
          MP4_JPEG: "mjpeg", "gif": "gif"}
# the counters of fgpack_vp8_stats, in order (golden_updates and
# altref_updates count refreshes and copies; the copies also by their source)
VP8_FEATURES = (
    "key_frames", "inter_frames", "hidden_frames", "intra_mbs_in_inter_frames",
    "bpred_mbs_in_inter_frames", "splitmv_mbs", "splitmv_4x4_mbs", "golden_mbs",
    "altref_mbs", "frames_with_lf_deltas", "frames_without_refresh_entropy_probs",
    "golden_updates", "altref_updates", "frames_with_sign_bias", "mbs_reading_past_edge",
    "frames_with_segmentation", "frames_without_refresh_last", "newmv_mbs", "nearmv_mbs",
    "nearestmv_mbs", "zeromv_mbs", "bilinear_frames", "simple_filter_frames",
    "unfiltered_frames", "golden_copies_from_last", "golden_copies_from_altref",
    "altref_copies_from_last", "altref_copies_from_golden",
)
# the counters of fgpack_vp9_stats, in order: frames by kind (hidden ones
# are decoded and not shown; superframes are packets of several frames);
# compound and sub-8x8 blocks; lossless, segmented, segment-map-updating
# and temporally predicted segmentation, multi-tile-column and
# multi-tile-row, TX_MODE_SELECT, switchable-filter, error-resilient,
# frame-parallel, adapted (backward adaptation ran), context-refreshing and
# previous-frame-MV frames; inter blocks by interpolation filter; blocks by
# tx size
VP9_FEATURES = (
    "key_frames", "inter_frames", "hidden_frames", "show_existing_frames", "superframes",
    "compound_blocks", "sub8x8_blocks", "lossless_frames", "segmented_frames",
    "segment_map_updates", "temporal_segment_frames", "multi_tile_frames", "tile_row_frames",
    "tx_select_frames", "switchable_frames", "error_resilient_frames", "frame_parallel_frames",
    "adapted_frames", "refresh_context_frames", "prev_frame_mv_frames", "regular_blocks",
    "smooth_blocks", "sharp_blocks", "bilinear_blocks", "tx4x4_blocks", "tx8x8_blocks",
    "tx16x16_blocks", "tx32x32_blocks",
)
# the counters of fgpack_mpeg4_stats, in order: VOPs by type, P-VOPs with
# vop_rounding_type 1, not-coded VOPs; macroblocks (intra in any VOP, intra
# in P-VOPs, inter, skipped, 4MV, ac_pred, dquant, reading past the edge);
# video packets after resync markers; B-VOP macroblocks by mode and those
# skipped with the next reference's; VOPs with MPEG quantisation and with
# matrices loaded from the VOL; third-escape coefficients; quarter-pel,
# data-partitioned and XviD-IDCT VOPs
MPEG4_FEATURES = (
    "i_vops", "p_vops", "b_vops", "rounding_type_1_vops", "not_coded_vops", "intra_mbs",
    "intra_mbs_in_p_vops", "inter_mbs", "skipped_mbs", "inter4v_mbs", "ac_pred_mbs",
    "dquant_mbs", "mbs_reading_past_edge", "video_packets", "direct_mbs", "forward_mbs",
    "backward_mbs", "interpolated_mbs", "b_skipped_mbs", "mpeg_quant_vops",
    "loaded_matrix_vops", "escape3_coefficients", "quarter_pel_vops", "partitioned_vops",
    "xvid_idct_vops",
)
# the counters of fgpack_mjpeg_stats, in order: frames by chroma sampling,
# frames with a restart interval, frames decoded by the standard Huffman
# tables (no DHT of their own); frames converted by swscale's unscaled 4:2:0
# and 4:2:2 paths and by its full-chroma path (4:4:4)
MJPEG_FEATURES = (
    "frames_420", "frames_422", "frames_444", "frames_with_restarts", "frames_without_dht",
    "unscaled_420_conversions", "unscaled_422_conversions", "full_chroma_conversions",
    "scaled_conversions",
)
# the counters of fgpack_gif_stats, in order: images decoded, interlaced,
# with a local colour table, with a transparency index, smaller than the
# screen; images by disposal method (none, in place, background, previous);
# images whose LZW data ended before their last row
GIF_FEATURES = (
    "images", "interlaced_images", "local_table_images", "transparent_images",
    "partial_images", "dispose_none", "dispose_in_place", "dispose_background",
    "dispose_previous", "short_images",
)
# FFmpeg's gif demuxer counts time in hundredths of a second
GIF_TICKS = 100
# MPEG-4 systems object types (an esds's objectTypeIndication) of mp4v entries
_OBJECT_TYPES = {0x20: "MPEG-4 Part 2", 0x21: "H.264", 0x60: "MPEG-2", 0x61: "MPEG-2",
                 0x6A: "MPEG-1", 0x6C: "JPEG"}
INT_MAX = 2**31 - 1


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


def _is_mp4(data: bytes) -> bool:
    return len(data) >= 8 and data[4:8] in MP4_BOXES


def _is_avi(data: bytes) -> bool:
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"AVI "


class _Mp4:
    """The first video track of an MP4/MOV file (fgpack_mp4_*): its
    sample-entry name ('avc1', 'mp4v (MPEG-4 Part 2)', 'mp4v (JPEG)', ...;
    '?' where the boxes do not say), sizes, samples and esds headers."""

    def __init__(self, lib, data: bytes):
        status = ctypes.c_int()
        handle = lib.fgpack_mp4_open(data, len(data), ctypes.byref(status))
        self.status = status.value
        self.name = "?"
        if not handle:
            return
        try:
            info = (ctypes.c_int64 * 12)()
            entry = ctypes.create_string_buffer(16)
            lib.fgpack_mp4_info(handle, info, entry, 16)
            self.name = entry.value.decode("latin-1")
            (self.width, self.height, n, self.timescale, self.stts_samples,
             self.stts_duration, oti, n_dsi) = (int(v) for v in info[:8])
            self.colr = tuple(int(v) for v in info[8:])  # primaries, transfer, matrix, full
            if oti >= 0:
                self.name += f" ({_OBJECT_TYPES.get(oti, f'object type 0x{oti:02x}')})"
            self.offsets, self.sizes = np.zeros(n, np.int64), np.zeros(n, np.int64)
            self.cts, self.keys = np.zeros(n, np.int64), np.zeros(n, np.uint8)
            dsi = (ctypes.c_uint8 * max(n_dsi, 1))()
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.fgpack_mp4_packets(handle, *(a.ctypes.data_as(i64p) for a in (
                self.offsets, self.sizes, self.cts)), _u8p(self.keys), dsi)
            self.dsi = bytes(dsi)[:n_dsi]
        finally:
            lib.fgpack_mp4_close(handle)


class VideoReader:
    """The frames of one video file (a path or its bytes), in order, as
    cv2.VideoCapture.read gives them: (H, W, 3) uint8 BGR.

    frame_count and fps are cv2's CAP_PROP_FRAME_COUNT and CAP_PROP_FPS.
    WebM: the fps is FFmpeg's avg_frame_rate from the track's
    DefaultDuration (av_reduce to terms of at most 30000), the count the
    container's duration times the fps rounded (OpenCV's get_total_frames;
    WebM stores no frame count), and the number of packets where the file
    has no Duration.  MP4: the count is FFmpeg's nb_frames (the samples
    stts counts), the fps its avg_frame_rate (the media timescale times
    that count over stts's total duration, av_reduce to INT_MAX).  AVI:
    the count is strh's dwLength (FFmpeg's nb_frames), the fps dwRate /
    dwScale (av_reduce to INT_MAX).  GIF: the count is every image in the
    file (FFmpeg's nb_frames), the fps 100 over the delays' total (in
    hundredths, 0 read as 10) divided by that count and truncated (100 over
    the total for one image); where that comes to 0, 100 for a file of one
    or two packets, and more packets are refused; images before the file's
    first extension, the first image's apart, are counted and not shown, as
    the gif parser leaves them in the first packet.
    `timings` accumulates seconds spent demuxing (once the file is in
    memory), decoding and converting.  Unsupported files raise ValueError
    naming the codec or the tool."""

    def __init__(self, src: Union[str, os.PathLike, bytes]):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self.data, self.name = bytes(src), "video bytes"
        else:
            with open(src, "rb") as f:
                self.data, self.name = f.read(), str(src)
        self._lib = _load()  # the library's first use builds it: not demuxing
        self._dec = None
        t0 = time.perf_counter()
        self.codec_tag = ""  # an AVI stream's fourcc (the MPEG-4 decoder's tag rules read it)
        self.siting = 0  # the chroma location a Matroska track states (an AVChromaLocation)
        self._colr = None  # an mp4v track's colr (colour space, full range)
        if self.data[:4] == EBML_MAGIC:
            self._open_webm()
        elif _is_mp4(self.data):
            self._open_mp4()
        elif _is_avi(self.data):
            self._open_avi()
        elif is_gif(self.data):
            self._open_gif()
        else:
            raise ValueError(f"{self.name}: not a container the port reads ({READS})")
        self._kind = AVI_TAGS[self.codec_tag.upper()] if self.codec_tag else _KINDS[self.codec]
        self._features = {"vp8": VP8_FEATURES, "vp9": VP9_FEATURES, "mpeg4": MPEG4_FEATURES,
                          "mjpeg": MJPEG_FEATURES, "gif": GIF_FEATURES}[self._kind]
        self._fn = {k: getattr(self._lib, f"fgpack_{self._kind}_{k}")
                    for k in ("new", "decode", "planes", "bgr", "stats", "free")}
        if self._kind != "vp8":
            self._fn["error"] = getattr(self._lib, f"fgpack_{self._kind}_error")
        self._dec = self._fn["new"]()
        if self._kind in ("vp8", "vp9") and self.siting:
            getattr(self._lib, f"fgpack_{self._kind}_siting")(self._dec, self.siting)
        self._next = 0
        self._flushed = False
        self._out = (ctypes.c_int64 * 4)()
        self._chroma = (1, 1)  # the chroma planes' subsampling (log2, vertical and horizontal)
        if self._kind == "mpeg4":
            if self._colr:
                self._lib.fgpack_mpeg4_colour(self._dec, *self._colr)
            size = (ctypes.c_int64 * 2)()
            self._lib.fgpack_mpeg4_codec_tag(self._dec, self.codec_tag.encode("latin-1"))
            self._check(self._lib.fgpack_mpeg4_headers(self._dec, self.dsi, len(self.dsi), size),
                        "the esds headers" if _is_mp4(self.data) else "the extradata")
            if size[0]:
                self.width, self.height = int(size[0]), int(size[1])
        elif self._kind == "mjpeg":
            self._mjpeg_header()
        self.timings = {"demux": time.perf_counter() - t0, "decode": 0.0, "convert": 0.0}

    def _refuse(self, codec: str):
        raise ValueError(f"{self.name}: video codec {codec!r} is not decoded by the port "
                         f"(it reads {READS})")

    def _refuse_colour_managed(self, primaries: int, transfer: int, where: str):
        """cv2 converts a frame whose stated primaries or transfer are
        outside fgpack_sws_colour_managed's sets through swscale's colour
        management (another gamut or curve), which the port does not."""
        if self._lib.fgpack_sws_colour_managed(primaries, transfer):
            raise ValueError(
                f"{self.name}: {where} states primaries {primaries} and transfer "
                f"{transfer}, which cv2 converts through swscale's colour management; the "
                f"port does not (video codec {self.codec!r})")

    def _open_webm(self):
        status = ctypes.c_int()
        handle = self._lib.fgpack_webm_open(self.data, len(self.data), ctypes.byref(status))
        if not handle:
            raise ValueError(f"{self.name}: {_status(status.value)}")
        try:
            info = (ctypes.c_int64 * 8)()
            duration = ctypes.c_double()
            codec = ctypes.create_string_buffer(64)
            self._lib.fgpack_webm_info(handle, info, ctypes.byref(duration), codec, 64)
            self.codec = codec.value.decode("latin-1")
            if status.value != 0:
                raise ValueError(
                    f"{self.name}: {_status(status.value)} (video codec {self.codec!r})")
            if self.codec not in ("V_VP8", "V_VP9", "V_MJPEG"):
                self._refuse(self.codec)
            self.width, self.height, n = int(info[0]), int(info[1]), int(info[2])
            default_duration, scale = int(info[3]), int(info[4])
            # cv2 converts VP8 and VP9 frames from the chroma siting the
            # Colour element states (it shows at odd heights only), and
            # Motion-JPEG's from the decoder's own centred siting
            self._refuse_colour_managed(int(info[6]), int(info[7]), "the track's Colour element")
            self.siting = int(info[5]) if self.codec != "V_MJPEG" else 0
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
        # the stream's size is its first key frame's (later key frames may
        # not change it)
        if n and self.codec == "V_VP8" and not self.data[self.offsets[0]] & 1 and self.sizes[0] >= 10:
            at = int(self.offsets[0])
            self.height = int.from_bytes(self.data[at + 8:at + 10], "little") & 0x3FFF
        elif n and self.codec == "V_VP9":
            self._vp9_size()
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
        self.dsi = b""

    def _vp9_size(self):
        """The size in the first packet's key-frame header; profiles 1-3
        and a stream that does not open on a key frame refused there,
        before any frame is decoded."""
        at, size = int(self.offsets[0]), int(self.sizes[0])
        out = (ctypes.c_int64 * 4)()
        rc = self._lib.fgpack_vp9_peek(self.data[at:at + size], size, out)
        if rc != 0:
            raise ValueError(f"{self.name}: packet 0: {_status(rc)} (video codec 'V_VP9')")
        if out[0] != 0:
            raise ValueError(f"{self.name}: VP9 profile {int(out[0])} (video codec 'V_VP9'; the "
                             "port decodes profile 0: 8-bit 4:2:0)")
        if not out[1]:
            raise ValueError(f"{self.name}: packet 0 is not a key frame (video codec 'V_VP9')")
        self.width, self.height = int(out[2]), int(out[3])

    def _mjpeg_header(self):
        """The first frame's header: its size, and the refusals FFmpeg's
        decoder would meet at once (progressive, 12-bit, ...; interlaced
        fields, which FFmpeg detects where the first frame is under three
        quarters of the container's height), before any frame is decoded."""
        if not len(self.sizes):
            return
        at, size = int(self.offsets[0]), int(self.sizes[0])
        out = (ctypes.c_int64 * 3)()
        self._check(self._lib.fgpack_mjpeg_headers(self._dec, self.data[at:at + size], size, out),
                    "packet 0")
        if self.height and out[1] < self.height * 3 // 4:
            raise ValueError(
                f"{self.name}: interlaced Motion-JPEG (fields of {int(out[0])}x{int(out[1])} in a "
                f"{self.width}x{self.height} stream; video codec {self.codec!r})")
        self.width, self.height = int(out[0]), int(out[1])

    def _open_avi(self):
        status = ctypes.c_int()
        handle = self._lib.fgpack_avi_open(self.data, len(self.data), ctypes.byref(status))
        if not handle:
            raise ValueError(f"{self.name}: {_status(status.value)}")
        try:
            info = (ctypes.c_int64 * 7)()
            compression, handler = ctypes.create_string_buffer(5), ctypes.create_string_buffer(5)
            self._lib.fgpack_avi_info(handle, info, compression, handler)
            tag = compression.raw[:4].decode("latin-1")
            self.codec_tag = tag
            kind = AVI_TAGS.get(tag.upper())
            self.codec = f"{tag} ({_AVI_CODECS[kind]})" if kind else tag
            if status.value != 0:
                raise ValueError(
                    f"{self.name}: {_status(status.value)} (video codec {self.codec!r})")
            if kind is None:
                self._refuse(tag)
            # avidec: an MPEG-4 stream whose strh handler is XVID takes that tag
            if kind == "mpeg4" and handler.raw[:4] == b"XVID":
                self.codec_tag = "XVID"
            self.width, self.height, n = int(info[0]), int(info[1]), int(info[2])
            rate, scale, length, n_extra = (int(v) for v in info[3:])
            self.offsets, self.sizes = np.zeros(n, np.int64), np.zeros(n, np.int64)
            self.keys = np.zeros(n, np.uint8)
            extra = (ctypes.c_uint8 * max(n_extra, 1))()
            i64p = ctypes.POINTER(ctypes.c_int64)
            self._lib.fgpack_avi_packets(handle, self.offsets.ctypes.data_as(i64p),
                                         self.sizes.ctypes.data_as(i64p), _u8p(self.keys), extra)
            self.dsi = bytes(extra)[:n_extra]
        finally:
            self._lib.fgpack_avi_close(handle)
        if not (rate and scale):  # avidec's default
            rate, scale = 25, 1
        num, den = av_reduce(rate, scale, INT_MAX)
        self.fps = num / den
        self.pts = (np.arange(len(self.sizes), dtype=np.int64) * 1_000_000_000 * scale) // rate
        self.frame_count = length  # 0 where strh has none, as cv2 reports it

    def _open_gif(self):
        try:
            gif = read_container(self.data)
        except ValueError as err:
            raise ValueError(f"{self.name}: {err} (video codec 'gif')") from None
        self.codec = "gif"
        self.width, self.height = gif.width, gif.height
        self.offsets, self.sizes = gif.offsets, gif.sizes
        self.keys = (np.arange(len(gif.sizes)) == 0).astype(np.uint8)
        self.dsi = b""
        self.frame_count = gif.images
        # gifdec: avg_frame_rate = 100 / (duration / nb_frames) in integers
        ticks = gif.duration // gif.images if gif.images > 1 else gif.duration
        if gif.images > 1 and not ticks and len(gif.sizes) > 2:
            raise ValueError(
                f"{self.name}: a GIF of {gif.images} images in {len(gif.sizes)} packets whose "
                f"delays total {gif.duration} hundredths of a second: cv2 reports FFmpeg's "
                "frame-rate estimate from the packets' timestamps for it (r_frame_rate), which "
                "the port does not reproduce (video codec 'gif')")
        # else where that is 0, FFmpeg has fewer than two timestamp steps to
        # estimate from, and OpenCV takes 1 / time_base
        num, den = av_reduce(GIF_TICKS, ticks, INT_MAX) if ticks > 0 else (GIF_TICKS, 1)
        self.fps = num / den

    def _open_mp4(self):
        track = _Mp4(self._lib, self.data)
        if track.status != 0:
            where = f" (video codec {track.name!r})" if track.name != "?" else ""
            raise ValueError(f"{self.name}: {_status(track.status)}{where}")
        self.codec = track.name
        if self.codec not in (MPEG4_PART2, MP4_JPEG):
            self._refuse(self.codec)
        # cv2 converts an mp4v frame in the colour space and range of the
        # sample entry's colr box (a VOL's colour description overrides
        # them); the Motion-JPEG decoder sets its own
        primaries, transfer, matrix, full = track.colr
        self._refuse_colour_managed(primaries, transfer, "the sample entry's colr box")
        if self.codec == MPEG4_PART2 and self._lib.fgpack_sws_matrix_row(matrix) < 0:
            raise ValueError(f"{self.name}: the sample entry's colr box states matrix "
                             f"{matrix}, which the port does not convert (video codec "
                             f"{self.codec!r})")
        self._colr = (matrix, full) if self.codec == MPEG4_PART2 else None
        self.width, self.height = track.width, track.height
        self.offsets, self.sizes, self.keys = track.offsets, track.sizes, track.keys
        self.pts = (track.cts * 1_000_000_000) // max(track.timescale, 1)
        self.dsi = track.dsi
        if track.stts_duration > 0 and track.stts_samples > 0 and track.timescale > 0:
            num, den = av_reduce(track.timescale * track.stts_samples, track.stts_duration,
                                 INT_MAX)
            self.fps = num / den
        else:
            self.fps = 0.0
        self.frame_count = track.stts_samples or len(self.sizes)

    def _check(self, rc: int, where: str):
        if rc == 0:
            return
        detail = ""
        if self._kind != "vp8":
            buf = ctypes.create_string_buffer(512)
            self._fn["error"](self._dec, buf, 512)
            detail = buf.value.decode("latin-1")
        if self._kind in ("vp9", "gif"):
            detail += f"{' ' if detail else ''}(video codec {self.codec!r})"
        raise ValueError(f"{self.name}: {where}: {_status(rc)}" + (f": {detail}" if detail else ""))

    def packets(self) -> List[bytes]:
        """The video track's packets in file order (cv2's CAP_PROP_FORMAT = -1)."""
        return [self.data[o:o + s] for o, s in zip(self.offsets, self.sizes)]

    def _decode_next(self) -> bool:
        """Decode packets up to the next frame out; False at the end (an
        MPEG-4 Part 2 stream with B-VOPs gives its last reference then)."""
        decode = self._fn["decode"]
        while self._next < len(self.sizes):
            o, s = int(self.offsets[self._next]), int(self.sizes[self._next])
            self._next += 1
            if not s and self._kind in ("mpeg4", "mjpeg"):
                continue  # an empty sample holds no frame (an empty packet flushes)
            t0 = time.perf_counter()
            rc = decode(self._dec, self.data[o:o + s], s, self._out)
            self.timings["decode"] += time.perf_counter() - t0
            self._check(rc, f"packet {self._next - 1}")
            if self._out[0]:
                return self._shown()
        if self._kind == "mpeg4" and not self._flushed:
            self._flushed = True
            self._check(decode(self._dec, b"", 0, self._out), "the end of the stream")
            if self._out[0]:
                return self._shown()
        return False

    def _shown(self) -> bool:
        self.width, self.height = int(self._out[1]), int(self._out[2])
        if self._kind == "mjpeg":  # 0 4:4:4, 1 4:2:2, 2 4:2:0
            self._chroma = (int(self._out[3] == 2), int(self._out[3] > 0))
        return True

    def read(self) -> Optional[np.ndarray]:
        """The next frame as (H, W, 3) uint8 BGR, None at the end."""
        if self._dec is None or not self._decode_next():
            return None
        t0 = time.perf_counter()
        frame = np.empty((self.height, self.width, 3), np.uint8)
        rc = self._fn["bgr"](self._dec, _u8p(frame))
        self.timings["convert"] += time.perf_counter() - t0
        self._check(rc, f"the conversion of frame {self._next - 1}")
        return frame

    def planes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The last frame's Y (H, W), U and V ((H + 1) // 2, (W + 1) // 2)
        planes (a Motion-JPEG frame's at its own sampling: (H, W / 2) for
        4:2:2, (H, W) for 4:4:4); Y is what cv2 returns with
        CAP_PROP_CONVERT_RGB = 0.  A GIF has no YUV planes: see canvas()."""
        if self._kind == "gif":
            raise ValueError(f"{self.name}: a GIF has no YUV planes; canvas() gives its BGRA")
        h, w = self.height, self.width
        vs, hs = self._chroma
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + vs) >> vs, (w + hs) >> hs), np.uint8)
        v = np.empty_like(u)
        if self._dec is None or self._fn["planes"](self._dec, _u8p(y), _u8p(u), _u8p(v)) != 0:
            raise ValueError(f"{self.name}: no decoded frame")
        return y, u, v

    def canvas(self) -> np.ndarray:
        """A GIF's last frame as its (H, W, 4) BGRA canvas, which is what cv2
        returns with CAP_PROP_CONVERT_RGB = 0."""
        if self._kind != "gif":
            raise ValueError(f"{self.name}: canvas() is a GIF's; {self.codec} has planes()")
        bgra = np.empty((self.height, self.width, 4), np.uint8)
        if self._dec is None or self._fn["planes"](self._dec, _u8p(bgra)) != 0:
            raise ValueError(f"{self.name}: no decoded frame")
        return bgra

    def features(self) -> Dict[str, int]:
        """How many frames, VOPs, macroblocks, blocks or images so far used
        each feature of the codec (VP8_FEATURES, VP9_FEATURES,
        MPEG4_FEATURES, MJPEG_FEATURES or GIF_FEATURES)."""
        if self._dec is None:
            raise ValueError(f"{self.name}: the reader is closed")
        out = (ctypes.c_int64 * len(self._features))()
        self._fn["stats"](self._dec, out, len(self._features))
        return dict(zip(self._features, (int(v) for v in out)))

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def close(self) -> None:
        if self._dec:
            self._fn["free"](self._dec)
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
