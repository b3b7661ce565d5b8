"""The port's host codec library (csrc/fgpack.cpp) through ctypes: FGPK
packs, JPEG decode and encode, PNG and WebP decode, RGB -> I420
(fgvc_tpu/data_io/fgpack.py, without libjpeg, PIL or cv2); its video
entry points (WebM, MP4 and AVI demuxing, VP8, VP9, MPEG-4 Part 2 and
Motion-JPEG decoding) are bound in data_io/video.py.

The library is C++17 with pthread alone.  It is compiled with g++ at first
use into ``build/host/libfgpack-<hash>.so`` at the root of the checkout
(``build/`` is git-ignored; the hash covers the sources and the flags):

    g++ -O2 -std=c++17 -shared -fPIC -o build/host/libfgpack-<hash>.so \
        fgvc_tpu_torch/csrc/fgpack.cpp fgvc_tpu_torch/csrc/mpeg4video.cpp \
        fgvc_tpu_torch/csrc/vp9video.cpp fgvc_tpu_torch/csrc/mjpeg.cpp \
        fgvc_tpu_torch/csrc/avi.cpp -lpthread

Its JPEG decoder gives libjpeg's default pixels (what PIL and cv2.imread
give), its WebP decoder libwebp's (cv2.imread's colour mode), and its
encoder libjpeg's default bytes (what cv2.imencode and PIL's
save write), so packs and frames are the same on every machine.  ctypes
releases the GIL around every call.

    write_fgpack("train.fgpack", frames)                      # raw uint8
    write_fgpack("train.fgpack", frames, codec="jpeg")        # JPEG q 95
    pack = FgPack("train.fgpack")
    batch = pack.read_batch([3, 7, 11], n_threads=4)          # RGB HWC
    planes = pack.read_batch(range(8), layout="i420")         # upload wire
    video = decode_jpeg_batch(list_of_jpeg_bytes)             # TAP-Vid path
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Iterable, List, NamedTuple, Optional, Sequence, Union

import numpy as np

_MAGIC = b"FGPK"
_VERSION = 2
_REC_FMT = "<QQIIII"  # offset, nbytes, h, w, c, codec
_REC_SIZE = struct.calcsize(_REC_FMT)

CODEC_RAW = 0
CODEC_JPEG = 1
_LAYOUTS = {"hwc": 0, "i420": 1, "grey": 2, "cmyk": 3}

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fgpack.cpp"
SOURCES = tuple(SOURCE.with_name(n) for n in (
    "fgpack.cpp", "mpeg4video.cpp", "vp9video.cpp", "mjpeg.cpp", "avi.cpp"))
# headers the sources include: in the library's hash, not on the command line
HEADERS = (SOURCE.with_name("jpeg_huffman.h"),)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LINK_FLAGS = ("-lpthread",)

# the library's status codes (enum Status of csrc/fgpack.cpp)
STATUS = {
    -1: "corrupt JPEG data",
    -2: "truncated JPEG data",
    -4: "arithmetic-coded JPEG is not supported",
    -5: "lossless or hierarchical JPEG is not supported",
    -6: "JPEG sample precision other than 8 bits is not supported",
    -7: "JPEG with other than 1, 3 or 4 components is not supported",
    -8: "JPEG with a fractional chroma sampling ratio is not supported",
    -9: "the frame's size differs from the batch's",
    -10: "record index out of range",
    -11: "the i420 layout needs even-sized (H, W, 3) frames",
    -12: "unknown record codec",
    -13: "no image in the JPEG data",
    -14: "invalid arguments",
    -15: "PNG filter type above 4",
    -16: "corrupt WebP data",
    -17: "truncated WebP data",
    -18: "animated WebP (ANIM/ANMF) is not supported",
    -19: "the alpha plane (ALPH) of a lossy WebP is not decoded",
    -20: "YCCK JPEG (Adobe transform 2) is not supported",
    -21: "layout 'cmyk' is for 4-component (CMYK) JPEGs, and they decode to nothing else",
    -22: "not a Matroska/WebM file (no EBML header with a Segment)",
    -23: "corrupt Matroska/WebM data",
    -24: "laced Matroska blocks are not supported",
    -25: "a compressed or encrypted Matroska track (ContentEncoding) is not supported",
    -26: "more than one video track",
    -27: "no video track",
    -28: "corrupt VP8 data",
    -29: "truncated VP8 data",
    -30: "a VP8 inter frame before the stream's first key frame",
    -31: "a VP8 key frame changes the stream's frame size",
    -32: "not an MP4/MOV file (no moov box)",
    -33: "corrupt MP4 data",
    -34: "no video track",
    -35: "an MP4 edit list that drops, delays or repeats samples is not supported",
    -36: "corrupt MPEG-4 Part 2 data",
    -37: "an MPEG-4 Part 2 tool the port does not decode",
    -38: "an MPEG-4 Part 2 P- or B-VOP before the stream's first I-VOP",
    -39: "an MPEG-4 Part 2 VOP before any VOL header",
    -40: "an MPEG-4 Part 2 VOL changes the stream's frame size",
    -41: "corrupt VP9 data",
    -42: "a VP9 form the port does not decode",
    -43: "a VP9 inter frame before the stream's first key frame",
    -44: "a VP9 frame changes the stream's frame size",
    -45: "corrupt AVI data",
    -46: "an OpenDML AVI's AVIX RIFF continuation (a file over 1 GB) is not supported",
    -47: "more than one video stream",
    -48: "no video stream",
    -49: "corrupt Motion-JPEG data",
    -50: "a Motion-JPEG form the port does not decode",
    -51: "a Motion-JPEG frame changes the stream's frame size",
    -52: "truncated Motion-JPEG data",
}

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES + HEADERS)
                            + " ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libfgpack-{digest.hexdigest()[:16]}.so"


def compiler_version() -> str:
    """The first line of `g++ --version`."""
    out = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    return out.stdout.splitlines()[0].strip()


def build_library(force: bool = False) -> str:
    """Compile SOURCES (csrc/fgpack.cpp, mpeg4video.cpp, vp9video.cpp,
    mjpeg.cpp and avi.cpp) into build/host (once per sources, headers and
    flags);
    returns the library's path.  The output is written under a temporary
    name and renamed, so a process loading it during another's build never
    sees half a file."""
    out = library_path()
    if out.exists() and not force:
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES), *LINK_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {', '.join(p.name for p in SOURCES)}:\n{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build_library())
        i64, ptr, u8p = ctypes.c_int64, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        sig = {
            "fgpack_open": (ptr, [ctypes.c_char_p]),
            "fgpack_count": (i64, [ptr]),
            "fgpack_record_info": (ctypes.c_int, [ptr, i64, i64p]),
            "fgpack_read_batch": (ctypes.c_int, [ptr, i64p, i64, u8p, i64, ctypes.c_int,
                                                 ctypes.c_int, i64p]),
            "fgpack_jpeg_info": (ctypes.c_int, [ctypes.c_char_p, i64, i64p]),
            "fgpack_decode_jpeg_batch": (ctypes.c_int, [ctypes.POINTER(ctypes.c_char_p), i64p,
                                                        i64, i64, i64, u8p, i64, ctypes.c_int,
                                                        ctypes.c_int, i64p]),
            "fgpack_encode_jpeg": (ctypes.c_int, [u8p, i64, i64, ctypes.c_int, ctypes.c_int,
                                                  ctypes.POINTER(ptr), i64p]),
            "fgpack_free": (None, [ptr]),
            "fgpack_rgb_to_i420_batch": (ctypes.c_int, [u8p, i64, i64, i64, u8p]),
            "fgpack_png_unfilter": (ctypes.c_int, [ctypes.c_char_p, i64, i64, ctypes.c_int,
                                                   u8p]),
            "fgpack_webp_info": (ctypes.c_int, [ctypes.c_char_p, i64, i64p]),
            "fgpack_decode_webp": (ctypes.c_int, [ctypes.c_char_p, i64, u8p, i64, i64,
                                                  ctypes.c_int]),
            "fgpack_webm_open": (ptr, [ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_int)]),
            "fgpack_webm_info": (ctypes.c_int, [ptr, i64p, ctypes.POINTER(ctypes.c_double),
                                                ctypes.c_char_p, i64]),
            "fgpack_webm_packets": (ctypes.c_int, [ptr, i64p, i64p, i64p, u8p]),
            "fgpack_webm_close": (None, [ptr]),
            "fgpack_vp8_new": (ptr, []),
            "fgpack_vp8_decode": (ctypes.c_int, [ptr, ctypes.c_char_p, i64, i64p]),
            "fgpack_vp8_planes": (ctypes.c_int, [ptr, u8p, u8p, u8p]),
            "fgpack_vp8_bgr": (ctypes.c_int, [ptr, u8p]),
            "fgpack_vp8_stats": (ctypes.c_int, [ptr, i64p, i64]),
            "fgpack_vp8_free": (None, [ptr]),
            "fgpack_i420_to_bgr24": (None, [u8p, u8p, u8p, i64, i64, i64, i64, u8p]),
            "fgpack_mp4_open": (ptr, [ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_int)]),
            "fgpack_mp4_info": (ctypes.c_int, [ptr, i64p, ctypes.c_char_p, i64]),
            "fgpack_mp4_packets": (ctypes.c_int, [ptr, i64p, i64p, i64p, u8p, u8p]),
            "fgpack_mp4_close": (None, [ptr]),
            "fgpack_mpeg4_new": (ptr, []),
            "fgpack_mpeg4_headers": (ctypes.c_int, [ptr, ctypes.c_char_p, i64, i64p]),
            "fgpack_mpeg4_decode": (ctypes.c_int, [ptr, ctypes.c_char_p, i64, i64p]),
            "fgpack_mpeg4_planes": (ctypes.c_int, [ptr, u8p, u8p, u8p]),
            "fgpack_mpeg4_bgr": (ctypes.c_int, [ptr, u8p]),
            "fgpack_mpeg4_stats": (ctypes.c_int, [ptr, i64p, i64]),
            "fgpack_mpeg4_error": (ctypes.c_int, [ptr, ctypes.c_char_p, i64]),
            "fgpack_mpeg4_free": (None, [ptr]),
            "fgpack_vp9_new": (ptr, []),
            "fgpack_vp9_peek": (ctypes.c_int, [ctypes.c_char_p, i64, i64p]),
            "fgpack_vp9_decode": (ctypes.c_int, [ptr, ctypes.c_char_p, i64, i64p]),
            "fgpack_vp9_planes": (ctypes.c_int, [ptr, u8p, u8p, u8p]),
            "fgpack_vp9_bgr": (ctypes.c_int, [ptr, u8p]),
            "fgpack_vp9_stats": (ctypes.c_int, [ptr, i64p, i64]),
            "fgpack_vp9_error": (ctypes.c_int, [ptr, ctypes.c_char_p, i64]),
            "fgpack_vp9_free": (None, [ptr]),
            "fgpack_mpeg4_codec_tag": (ctypes.c_int, [ptr, ctypes.c_char_p]),
            "fgpack_avi_open": (ptr, [ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_int)]),
            "fgpack_avi_info": (ctypes.c_int, [ptr, i64p, ctypes.c_char_p, ctypes.c_char_p]),
            "fgpack_avi_packets": (ctypes.c_int, [ptr, i64p, i64p, u8p, u8p]),
            "fgpack_avi_close": (None, [ptr]),
            "fgpack_mjpeg_new": (ptr, []),
            "fgpack_mjpeg_headers": (ctypes.c_int, [ptr, ctypes.c_char_p, i64, i64p]),
            "fgpack_mjpeg_decode": (ctypes.c_int, [ptr, ctypes.c_char_p, i64, i64p]),
            "fgpack_mjpeg_planes": (ctypes.c_int, [ptr, u8p, u8p, u8p]),
            "fgpack_mjpeg_bgr": (ctypes.c_int, [ptr, u8p]),
            "fgpack_mjpeg_stats": (ctypes.c_int, [ptr, i64p, i64]),
            "fgpack_mjpeg_error": (ctypes.c_int, [ptr, ctypes.c_char_p, i64]),
            "fgpack_mjpeg_free": (None, [ptr]),
            "fgpack_prefetch": (ctypes.c_int, [ptr, i64, i64]),
            "fgpack_close": (None, [ptr]),
        }
        for name, (restype, argtypes) in sig.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
        return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _status(rc: int) -> str:
    return STATUS.get(rc, f"status {rc}")


# --------------------------------------------------------------------- #
# JPEG


class JpegInfo(NamedTuple):
    height: int
    width: int
    components: int
    adobe: int        # the Adobe APP14 marker's transform, -1 without one


def jpeg_info(buf: bytes) -> JpegInfo:
    """The header of a JPEG, from its markers before the first scan;
    ValueError for what the decoder refuses (arithmetic, lossless, 12-bit,
    ...)."""
    out = (ctypes.c_int64 * 4)()
    rc = _load().fgpack_jpeg_info(buf, len(buf), out)
    if rc != 0:
        raise ValueError(_status(rc))
    return JpegInfo(*(int(v) for v in out))


def encode_jpeg(rgb: np.ndarray, quality: int = 95, sampling: str = "420") -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JPEG bytes, equal to
    cv2.imencode('.jpg', rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    (libjpeg's defaults: 4:2:0, the standard tables scaled to `quality`);
    sampling '444' keeps the chroma whole, as cv2's
    IMWRITE_JPEG_SAMPLING_FACTOR_444 does."""
    if sampling not in ("420", "444"):
        raise ValueError(f"sampling must be '420' or '444', got {sampling!r}")
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg needs (H, W, 3) RGB, got {rgb.shape}")
    lib = _load()
    out = ctypes.c_void_p()
    n = ctypes.c_int64()
    rc = lib.fgpack_encode_jpeg(_u8p(rgb), rgb.shape[0], rgb.shape[1], int(quality),
                                int(sampling == "444"), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"JPEG encode failed: {_status(rc)}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.fgpack_free(out)


def _out_shape(h: int, w: int, c: int, layout: int):
    if layout == 1:  # I420 planes
        if c != 3 or h % 2 or w % 2:
            raise ValueError("i420 layout needs even-sized (H, W, 3) records")
        return (h * 3 // 2, w)
    return (h, w) if c == 1 else (h, w, c)


def decode_jpeg_batch(
    bufs: Sequence[bytes],
    layout: str = "hwc",
    n_threads: int = 4,
) -> np.ndarray:
    """Decode same-sized in-memory JPEG frames in the library's thread pool
    (GIL-free).  layout 'hwc': (N, H, W, 3) uint8 RGB, what PIL gives (a grey
    frame as three equal channels); a batch of CMYK (4-component) frames
    gives (N, H, W, 4) as np.array(PIL.Image.open(...)) does: the samples,
    inverted where the file has an Adobe marker (PIL's 'CMYK;I').  'i420':
    (N, H*3//2, W) planes.  'grey': (N, H, W), libjpeg's JCS_GRAYSCALE output
    (the Y plane; an RGB file's rgb_gray_convert).  'cmyk': a CMYK file's
    (N, H, W, 4) samples as libjpeg gives them.  The size comes from each
    frame's SOF marker; a frame of another size or kind, or one the decoder
    refuses (YCCK among them), raises ValueError naming the frame."""
    n = len(bufs)
    if n == 0:
        raise ValueError("empty batch")
    lay = _LAYOUTS[layout]
    h = w = None
    headers = []
    for i, b in enumerate(bufs):
        try:
            headers.append(jpeg_info(b))
        except ValueError as e:
            raise ValueError(f"frame {i}: {e}") from None
        hw = headers[-1][:2]
        h, w = (h, w) if h is not None else hw
        if hw != (h, w):
            raise ValueError(f"frame {i}: {_status(-9)} ({hw} vs {(h, w)})")
    cmyk = [hd.components == 4 for hd in headers]
    if layout == "hwc" and any(cmyk):
        if not all(cmyk):
            raise ValueError(f"frame {cmyk.index(False)}: not CMYK, as frame "
                             f"{cmyk.index(True)} is")
        lay = _LAYOUTS["cmyk"]
    shape = _out_shape(h, w, {2: 1, 3: 4}.get(lay, 3), lay)
    dst = np.empty((n, *shape), np.uint8)
    arr = (ctypes.c_char_p * n)(*bufs)
    sizes = (ctypes.c_int64 * n)(*[len(b) for b in bufs])
    status = (ctypes.c_int64 * 2)()
    rc = _load().fgpack_decode_jpeg_batch(arr, sizes, n, h, w, _u8p(dst), int(np.prod(shape)),
                                          int(n_threads), lay, status)
    if rc != 0:
        raise ValueError(f"frame {status[0]}: {_status(int(status[1]))}")
    if layout == "hwc" and lay == _LAYOUTS["cmyk"]:
        for i, hd in enumerate(headers):
            if hd.adobe >= 0:
                np.subtract(255, dst[i], out=dst[i])
    return dst


def decode_jpeg(buf: bytes) -> np.ndarray:
    """One JPEG -> (H, W, 3) uint8 RGB (a grey JPEG as three equal channels),
    or (H, W, 4) for a CMYK file, as decode_jpeg_batch gives it."""
    return decode_jpeg_batch([buf], n_threads=1)[0]


# --------------------------------------------------------------------- #
# WebP

WEBP_MAGIC = (b"RIFF", b"WEBP")  # bytes 0-3 and 8-11 of a WebP file


class WebpInfo(NamedTuple):
    height: int
    width: int
    has_alpha: bool   # VP8X's alpha flag, or VP8L's alpha bit
    lossless: bool    # VP8L (else a VP8 key frame)
    exif: bytes       # the EXIF chunk (a bare TIFF header) where VP8X flags it


def webp_info(buf: bytes) -> WebpInfo:
    """The header of a WebP file; ValueError for what the decoder refuses
    (animations, corrupt or truncated containers)."""
    out = (ctypes.c_int64 * 6)()
    rc = _load().fgpack_webp_info(buf, len(buf), out)
    if rc != 0:
        raise ValueError(_status(rc))
    exif = buf[out[4]:out[4] + out[5]] if out[4] >= 0 else b""
    return WebpInfo(int(out[0]), int(out[1]), bool(out[2]), bool(out[3]), exif)


def decode_webp(buf: bytes, alpha: bool = False,
                info: Optional[WebpInfo] = None) -> np.ndarray:
    """One WebP file -> (H, W, 3) uint8 BGR, what cv2.imread gives before the
    EXIF orientation: lossy frames through libwebp's fancy upsampling and
    fixed-point YUV -> RGB, lossless ones exactly; alpha dropped.  With
    `alpha`, (H, W, 4) BGRA (255 where the file has no alpha; a lossy
    frame's ALPH plane is refused).  `info` is the file's webp_info where
    the caller has read it already."""
    info = info or webp_info(buf)
    ch = 4 if alpha else 3
    dst = np.empty((info.height, info.width, ch), np.uint8)
    rc = _load().fgpack_decode_webp(buf, len(buf), _u8p(dst), info.height, info.width, ch)
    if rc != 0:
        raise ValueError(_status(rc))
    return dst


# --------------------------------------------------------------------- #
# PNG

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's seven passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


class PngImage(NamedTuple):
    samples: np.ndarray            # (H, W, C) uint8 or uint16 (palette: indices)
    color_type: int                # 0 grey, 2 RGB, 3 palette, 4 grey+alpha, 6 RGBA
    bit_depth: int
    palette: Optional[np.ndarray]  # (n, 3) uint8 RGB of a palette image
    trns: Optional[bytes]          # the tRNS chunk's body
    exif: Optional[bytes] = None   # the eXIf chunk's body (a TIFF header on)


def _png_pass(raw: bytes, at: int, h: int, w: int, ch: int, depth: int, name: str):
    """Unfilter the (h, w) sub-image whose filtered rows start at raw[at:];
    returns its (h, w, ch) samples (1/2/4-bit ones unpacked, not scaled)
    and the offset past its rows."""
    rowbytes = (w * ch * depth + 7) // 8
    end = at + h * (rowbytes + 1)
    if len(raw) < end:
        raise ValueError(f"{name}: truncated PNG image data")
    out = np.empty((h, rowbytes), np.uint8)
    rc = _load().fgpack_png_unfilter(raw[at:end], h, rowbytes, max(1, ch * depth // 8),
                                     _u8p(out))
    if rc != 0:
        raise ValueError(f"{name}: {_status(rc)}")
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w, ch), end
    if depth == 8:
        return out.reshape(h, w, ch), end
    per = 8 // depth  # 1, 2 or 4 bits: grey or palette, one channel
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (out[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w, None].astype(np.uint8), end


def decode_png(data: bytes, name: str = "PNG") -> PngImage:
    """PNG bytes -> samples: chunks checked (CRC), IDAT inflated by zlib,
    rows unfiltered by the library, 1/2/4-bit samples unpacked (grey ones
    scaled to 8 bits, as libpng's expand does; palette indices kept).  An
    Adam7-interlaced image is unfiltered pass by pass, each on its own
    sub-image, and each pass scattered to its pixels."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, ihdr, plte, trns, exif, idat = 8, None, None, None, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG chunk {tag!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: CRC error in PNG chunk {tag!r}")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"eXIf":
            exif = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{name}: unsupported PNG colour type {ctype} at {depth} bits")
    if interlace > 1:
        raise ValueError(f"{name}: unknown PNG interlace method {interlace}")
    if ctype == 3 and plte is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    ch = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        samples, _ = _png_pass(raw, 0, h, w, ch, depth, name)
    else:
        samples = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no rows, not even filter bytes
            samples[y0::dy, x0::dx], at = _png_pass(raw, at, ph, pw, ch, depth, name)
    if depth < 8 and ctype == 0:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    return PngImage(np.ascontiguousarray(samples), ctype, depth, plte, trns, exif)


# --------------------------------------------------------------------- #
# I420


def rgb_to_i420_batch(video: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) or (H, W, 3) uint8 RGB -> I420 planes (..., H*3//2, W),
    equal to cv2.cvtColor(frame, cv2.COLOR_RGB2YUV_I420); one GIL-free call
    for the whole video."""
    single = video.ndim == 3
    v = np.ascontiguousarray(video[None] if single else video, np.uint8)
    n, h, w, c = v.shape
    if c != 3 or h % 2 or w % 2:
        raise ValueError("rgb_to_i420_batch needs even-sized RGB frames")
    dst = np.empty((n, h * 3 // 2, w), np.uint8)
    rc = _load().fgpack_rgb_to_i420_batch(_u8p(v), n, h, w, _u8p(dst))
    if rc != 0:
        raise ValueError(f"rgb_to_i420_batch: {_status(rc)}")
    return dst[0] if single else dst


# --------------------------------------------------------------------- #
# packs


def write_fgpack(
    path: str,
    frames: Iterable[np.ndarray],
    codec: str = "raw",
    quality: int = 95,
) -> int:
    """Pack (H, W, C) uint8 frames into `path`; returns the record count.
    The bytes equal the JAX package's write_fgpack for the same frames
    (its JPEG records are cv2.imencode's, which encode_jpeg equals).

    codec='jpeg' stores JPEG blobs (RGB frames only); the reader decodes
    them in its thread pool.  The index records the DECODED h/w/c."""
    if codec not in ("raw", "jpeg"):
        raise ValueError(f"unknown codec {codec!r}")
    codec_id = CODEC_RAW if codec == "raw" else CODEC_JPEG
    frames = list(frames)
    n = len(frames)
    header = _MAGIC + struct.pack("<I", _VERSION) + struct.pack("<Q", n)
    offset = len(header) + n * _REC_SIZE
    index, blobs = [], []
    for f in frames:
        f = np.ascontiguousarray(f, dtype=np.uint8)
        h, w = f.shape[:2]
        c = f.shape[2] if f.ndim == 3 else 1
        if codec_id == CODEC_JPEG:
            if c != 3:
                raise ValueError("codec='jpeg' requires (H, W, 3) RGB frames")
            blob = encode_jpeg(f, quality)
        else:
            blob = f.tobytes()
        index.append(struct.pack(_REC_FMT, offset, len(blob), h, w, c, codec_id))
        blobs.append(blob)
        offset += len(blob)
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(b"".join(index))
        for b in blobs:
            fh.write(b)
    return n


class FgPack:
    """Reader of an FGPK pack over the library (mmap and a thread pool)."""

    def __init__(self, path: Union[str, os.PathLike]):
        self._lib = _load()
        self._h = self._lib.fgpack_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"cannot open fgpack file {path}")

    def __len__(self) -> int:
        return int(self._lib.fgpack_count(self._h))

    def _info(self, i: int):
        out = (ctypes.c_int64 * 5)()
        if self._lib.fgpack_record_info(self._h, int(i), out) != 0:
            raise IndexError(i)
        return [int(v) for v in out]

    def record_shape(self, i: int):
        """Decoded (h, w, c) of record i."""
        return tuple(self._info(i)[:3])

    def record_codec(self, i: int) -> int:
        return self._info(i)[4]

    def prefetch(self, lo: int, hi: int) -> None:
        self._lib.fgpack_prefetch(self._h, lo, hi)

    def read_batch(
        self,
        indices: Sequence[int],
        n_threads: int = 4,
        layout: str = "hwc",
    ) -> List[np.ndarray]:
        """Threaded batch read and decode; the records must share one
        decoded shape.  layout 'hwc': uint8 HWC (RGB for JPEG records);
        'i420': YUV 4:2:0 planes (h*3//2, w), the upload wire format
        (ops/color.py).  A failed record raises ValueError naming it."""
        indices = [int(i) for i in indices]
        h, w, c = self.record_shape(indices[0])
        lay = _LAYOUTS[layout]
        shape = _out_shape(h, w, c, lay)
        n = len(indices)
        dst = np.empty((n, *shape), np.uint8)
        idx = (ctypes.c_int64 * n)(*indices)
        status = (ctypes.c_int64 * 2)()
        rc = self._lib.fgpack_read_batch(self._h, idx, n, _u8p(dst), int(np.prod(shape)),
                                         int(n_threads), lay, status)
        if rc != 0:
            i = int(status[0])
            raise ValueError(f"record {indices[i]} (slot {i}): {_status(int(status[1]))}")
        return list(dst)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.read_batch([i], n_threads=1)[0]

    def close(self):
        if self._h:
            self._lib.fgpack_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
