"""GIF files through the port's host library (csrc/gif.cpp), without PIL or
cv2.

Writing: ``encode_gif`` gives the bytes that PIL's GifImagePlugin writes for
``frames[0].save(path, save_all=True, append_images=frames[1:],
duration=duration, loop=0)`` of uint8 RGB frames (fgvc_tpu's save_video of
a .gif).  Each frame is quantised on its own to PIL's median-cut palette
(``quantize``: Image.convert("P", palette=Palette.ADAPTIVE)); a frame under
512 x 512 pixels has its palette cut to the entries it uses where one at or
past their count is used, or where their count is at most half the
palette's power-of-two size (PIL's optimize, on by default).  Later frames
are deltas of the frame before: compared by index where the palettes are
the same and by colour where not, a frame equal to the one before is dropped
and its duration added to that one's; otherwise the unchanged pixels take a
transparency index (the palette's length, or its highest unused entry; none
where all 256 are used), and the frame is cropped to the box of what changed
and written with a local colour table.  Where one frame is left (one frame,
or all equal) the file is PIL's single frame: interlaced unless a side is
under 16 pixels, with the summed duration.  Durations are stored in
hundredths of a second (int(ms / 10)).

    data = encode_gif(frames, duration=int(1000 / 24))   # (T, H, W, 3) RGB
    palette, index = quantize(rgb)        # PIL's palette bytes, (H, W) uint8

Reading: ``GifContainer`` holds a file's blocks as FFmpeg's gif demuxer and
parser give them to cv2.VideoCapture (the frame count, the duration, the
packets); data_io/video.py's VideoReader decodes its packets one at a time.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from fgvc_tpu_torch.data_io.fgpack import _load, _status, _u8p

OPTIMIZE_PIXELS = 512 * 512
INTERLACE_MIN_SIDE = 16
GIF_SIGNATURES = (b"GIF87a", b"GIF89a")


def quantize(rgb: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """PIL's convert("P", palette=Palette.ADAPTIVE) of an (H, W, 3) uint8 RGB
    image: the palette (3 bytes an entry, at most 256) and the (H, W) index
    image."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or not rgb.size:
        raise ValueError(f"quantize needs an (H, W, 3) image, got {rgb.shape}")
    h, w = rgb.shape[:2]
    palette = np.zeros(768, np.uint8)
    n = ctypes.c_int64()
    index = np.empty((h, w), np.uint8)
    rc = _load().fgpack_gif_quantize(_u8p(rgb), h * w, _u8p(palette), ctypes.byref(n),
                                     _u8p(index))
    if rc != 0:
        raise ValueError(f"quantize: {_status(rc)}")
    return palette[:3 * n.value].tobytes(), index


def lzw_blocks(index: np.ndarray, interlace: bool = False) -> bytes:
    """PIL's GIF image data for an (H, W) index image: the minimum code size
    byte (8), the LZW codes in sub-blocks and the terminator."""
    index = np.ascontiguousarray(index, np.uint8)
    h, w = index.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int64()
    lib = _load()
    rc = lib.fgpack_gif_lzw(_u8p(index), w, h, int(interlace), ctypes.byref(out),
                            ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"lzw_blocks: {_status(rc)}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.fgpack_free(out)


class _Frame:
    """One frame as PIL holds it on the way out: its index image, palette
    bytes, the box it is cropped to (None for the first), its duration and
    transparency index."""

    def __init__(self, index: np.ndarray, palette: bytes, duration: int):
        self.index, self.palette, self.duration = index, palette, duration
        self.bbox: Optional[Tuple[int, int, int, int]] = None
        self.transparency: Optional[int] = None


def _normalize(rgb: np.ndarray) -> Tuple[np.ndarray, bytes]:
    """_normalize_mode and _normalize_palette with optimize on: the quantised
    frame, its palette cut to the entries in use where _get_optimize says."""
    palette, index = quantize(rgb)
    h, w = index.shape
    if w * h >= OPTIMIZE_PIXELS:
        return index, palette
    used = np.flatnonzero(np.bincount(index.ravel(), minlength=256))
    size = 1 << (len(palette) // 3 - 1).bit_length()
    if used[-1] >= len(used) or (len(used) <= size // 2 and size > 2):
        positions = np.zeros(256, np.uint8)
        positions[used] = np.arange(len(used), dtype=np.uint8)
        palette = b"".join(palette[3 * i:3 * i + 3] for i in used)
        index = positions[index]
    return index, palette


def _colours(index: np.ndarray, palette: bytes) -> np.ndarray:
    return np.frombuffer(palette, np.uint8).reshape(-1, 3)[index]


def _new_color_index(index: np.ndarray, palette: bytes) -> Optional[int]:
    """ImagePalette._new_color_index: the palette's length, else the highest
    unused entry, else None (all 256 used)."""
    n = len(palette) // 3
    if n < 256:
        return n
    unused = np.flatnonzero(np.bincount(index.ravel(), minlength=256) == 0)
    return int(unused[-1]) if len(unused) else None


def _table_size(palette: bytes) -> int:
    """_get_color_table_size: the 3-bit size field of a colour table."""
    if not palette:
        return 0
    if len(palette) < 9:
        return 1
    return math.ceil(math.log(len(palette) // 3, 2)) - 1


def _table(palette: bytes) -> bytes:
    """_get_header_palette: the palette padded with black to 2 << size entries."""
    pad = (2 << _table_size(palette)) - len(palette) // 3
    return palette + bytes(3 * pad) if pad > 0 else palette


def _global_header(width: int, height: int, palette: bytes) -> bytes:
    """_get_global_header: the screen descriptor, the global table and the
    NETSCAPE2.0 extension with a loop count of 0 (for ever)."""
    return (b"GIF89a" + struct.pack("<HHBBB", width, height, _table_size(palette) + 128, 0, 0)
            + _table(palette) + b"!\xff\x0bNETSCAPE2.0\x03\x01\0\0\0")


def _image(index: np.ndarray, offset: Tuple[int, int], duration: int,
           transparency: Optional[int], palette: Optional[bytes], interlace: bool) -> bytes:
    """_write_local_header and _write_frame_data: the graphic control
    extension (where there is a transparency index or a delay), the image
    descriptor, a local table where given, the LZW data."""
    out = []
    delay = int(duration / 10)
    if transparency is not None or delay != 0:
        out.append(b"!\xf9\x04" + struct.pack("<BHBB", 1 if transparency is not None else 0,
                                              delay, transparency or 0, 0))
    flags = 64 if interlace else 0
    size = _table_size(palette) if palette is not None else 0
    if size:
        flags |= 128 | size
    h, w = index.shape
    out.append(b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, flags))
    if size:
        out.append(_table(palette))
    out.append(lzw_blocks(index, interlace))
    return b"".join(out)


def encode_gif(frames: Sequence[np.ndarray], duration: int) -> bytes:
    """The bytes PIL writes for save(save_all=True, append_images=...,
    duration=duration, loop=0) of (H, W, 3) uint8 RGB frames, with
    optimize on (its default where no palette is given)."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("encode_gif needs at least one frame")
    kept: List[_Frame] = []
    previous: Optional[_Frame] = None
    for rgb in frames:
        if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.shape != frames[0].shape:
            raise ValueError(f"encode_gif needs (H, W, 3) frames of one size, got {rgb.shape}")
        frame = _Frame(*_normalize(rgb), duration)
        if previous is None:
            previous = frame
            kept.append(frame)
            continue
        if frame.palette == previous.palette:
            changed = frame.index != previous.index
        else:
            changed = (_colours(frame.index, frame.palette)
                       != _colours(previous.index, previous.palette)).any(-1)
        rows, cols = np.flatnonzero(changed.any(1)), np.flatnonzero(changed.any(0))
        if not len(rows):
            if duration:
                kept[-1].duration += duration
            continue
        previous = frame
        out = _Frame(frame.index, frame.palette, duration)
        out.bbox = (int(cols[0]), int(rows[0]), int(cols[-1]) + 1, int(rows[-1]) + 1)
        out.transparency = _new_color_index(frame.index, frame.palette)
        if out.transparency is not None:
            out.index = np.where(changed, frame.index, np.uint8(out.transparency))
        kept.append(out)

    h, w = frames[0].shape[:2]
    first = kept[0]
    out = [_global_header(w, h, first.palette)]
    if len(kept) == 1:  # PIL's single-frame path
        out.append(_image(first.index, (0, 0), first.duration, None, None,
                          min(h, w) >= INTERLACE_MIN_SIDE))
    else:
        out.append(_image(first.index, (0, 0), first.duration, None, None, False))
        for frame in kept[1:]:
            x0, y0, x1, y1 = frame.bbox
            out.append(_image(frame.index[y0:y1, x0:x1], (x0, y0), frame.duration,
                              frame.transparency, frame.palette, False))
    out.append(b";")
    return b"".join(out)


class GifContainer(NamedTuple):
    """A GIF's blocks as cv2's FFmpeg reads them: the logical screen's size,
    the image count (nb_frames, cv2's CAP_PROP_FRAME_COUNT), the delays'
    total in hundredths of a second (0 read as 10), and the gif parser's
    packets (offsets and sizes), each decoded to one frame."""
    width: int
    height: int
    images: int
    duration: int
    offsets: np.ndarray
    sizes: np.ndarray


def is_gif(data: bytes) -> bool:
    return data[:6] in GIF_SIGNATURES


def read_container(data: bytes) -> GifContainer:
    """The blocks of a GIF file's bytes; ValueError for a file the reader
    refuses (csrc/gif.cpp's statuses)."""
    lib = _load()
    status = ctypes.c_int()
    handle = lib.fgpack_gif_open(data, len(data), ctypes.byref(status))
    if not handle:
        raise ValueError(_status(status.value))
    try:
        info = (ctypes.c_int64 * 5)()
        lib.fgpack_gif_info(handle, info)
        width, height, images, duration, n = (int(v) for v in info)
        offsets, sizes = np.zeros(n, np.int64), np.zeros(n, np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fgpack_gif_packets(handle, offsets.ctypes.data_as(i64p), sizes.ctypes.data_as(i64p))
    finally:
        lib.fgpack_gif_close(handle)
    return GifContainer(width, height, images, duration, offsets, sizes)
