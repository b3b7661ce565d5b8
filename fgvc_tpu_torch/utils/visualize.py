"""Trajectory, correspondence and mask rendering and the video and image
writers of the port (fgvc_tpu/utils/visualize.py), in numpy alone.

The drawing gives OpenCV's pixels: ``fill_circle`` is cv2.circle(img, c, r,
colour, -1) (its midpoint circle as horizontal spans) and ``draw_line``
cv2.line(img, p0, p1, colour, 1) (LINE_8: clipLine, then LineIterator's
Bresenham walk from the left end), both clipped at the borders.

``save_video`` writes an ``.mp4`` of Motion-JPEG samples (each frame
data_io.fgpack.encode_jpeg's baseline JPEG at quality 95 and 4:4:4, equal
to cv2.imencode's with IMWRITE_JPEG_SAMPLING_FACTOR_444: 4:2:0 would halve
the chroma of the one-pixel coloured tails) in an ISO-BMFF file: an 'mp4v'
sample entry whose esds says objectTypeIndication 0x6C (ISO 10918-1), as
FFmpeg's muxer stores MJPEG in MP4, so FFmpeg-based players
(cv2.VideoCapture among them) read it, and so does the port's own
data_io.video.VideoReader (cv2.VideoCapture's pixels: FFmpeg's Motion-JPEG
decoding and 4:4:4 conversion), which cli.demo --video opens it with.
``read_video`` reads exactly such files back, as libjpeg decodes them.  ``save_image`` writes ``.png`` (zlib, filter 0) or
``.jpg`` (encode_jpeg at quality 95, cv2.imwrite's default).
"""

from __future__ import annotations

import colorsys
import struct
import zlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from fgvc_tpu_torch.data_io.fgpack import encode_jpeg

JPEG_QUALITY = 95


def point_colors(n: int) -> np.ndarray:
    """(n, 3) uint8 distinct hues."""
    cols = []
    for i in range(n):
        r, g, b = colorsys.hsv_to_rgb(i / max(n, 1), 1.0, 1.0)
        cols.append((int(r * 255), int(g * 255), int(b * 255)))
    return np.array(cols, np.uint8).reshape(n, 3)


# ---------------------------------------------------------------------- #
# OpenCV's LINE_8 primitives
# ---------------------------------------------------------------------- #
def _circle_spans(radius: int) -> np.ndarray:
    """Half-width of cv2's filled circle on each row offset -r .. r (index
    offset + r): the union of the spans its midpoint loop draws."""
    half = np.full(2 * radius + 1, -1, np.int64)
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for off, w in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            half[off + radius] = max(half[off + radius], w)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return half


def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int, color) -> None:
    """cv2.circle(img, center, radius, color, -1) in place: integer centre,
    LINE_8, the part inside the image."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    for off, half in enumerate(_circle_spans(int(radius)), start=-int(radius)):
        y = cy + off
        if 0 <= y < h and half >= 0:
            x0, x1 = max(cx - half, 0), min(cx + half, w - 1)
            if x0 <= x1:
                img[y, x0:x1 + 1] = color


def clip_line(w: int, h: int, p1, p2):
    """cv2.clipLine on the image rect: the endpoints moved onto the border
    (the double quotient truncated, as OpenCV casts it), or None where the
    segment misses the image."""
    if w <= 0 or h <= 0:
        return None
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def line_pixels(w: int, h: int, p1, p2) -> Tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of cv2.line(img, p1, p2, colour, 1) with LINE_8 on a w x h
    image: clipLine, then LineIterator from the left end (leftToRight), the
    major axis stepped every pixel and the minor one where the error goes
    negative."""
    p1, p2 = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    inside = all(0 <= p[0] < w and 0 <= p[1] < h for p in (p1, p2))
    if not inside:
        clipped = clip_line(w, h, p1, p2)
        if clipped is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        p1, p2 = clipped
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err, plus, minus = major - 2 * minor, 2 * major, -2 * minor
    steps = np.zeros(major + 1, np.int64)  # minor steps taken before pixel i
    taken = 0
    for i in range(1, major + 1):
        if err < 0:
            taken += 1
            err += minus + plus
        else:
            err += minus
        steps[i] = taken
    run = np.arange(major + 1, dtype=np.int64)
    if vert:
        return p1[0] + steps, p1[1] + sy * run
    return p1[0] + run, p1[1] + sy * steps


def draw_line(img: np.ndarray, p1, p2, color) -> None:
    """cv2.line(img, p1, p2, color, 1) in place (LINE_8)."""
    xs, ys = line_pixels(img.shape[1], img.shape[0], p1, p2)
    img[ys, xs] = color


# ---------------------------------------------------------------------- #
# renders
# ---------------------------------------------------------------------- #
def paint_point_track(
    frames: np.ndarray,        # (T, H, W, 3) uint8
    tracks: np.ndarray,        # (P, T, 2) (x, y)
    visibles: Optional[np.ndarray] = None,  # (P, T)
    radius: int = 3,
) -> np.ndarray:
    """Draw tracked points on every frame (filled circles, per-point hue),
    centres rounded half to even; points with a negative coordinate or not
    visible are skipped."""
    T, P = frames.shape[0], tracks.shape[0]
    cols = point_colors(P)
    out = frames.copy()
    for t in range(T):
        for p in range(P):
            if visibles is not None and not visibles[p, t]:
                continue
            x, y = tracks[p, t]
            if x < 0 or y < 0:
                continue
            fill_circle(out[t], (int(np.round(x)), int(np.round(y))), radius, cols[p])
    return out


def draw_trajectory_tails(frames: np.ndarray, tracks: np.ndarray, tail: int = 8) -> np.ndarray:
    """Add a polyline tail of the last `tail` steps behind each point
    (endpoints truncated to integers; a step with a negative coordinate is
    skipped)."""
    out = frames.copy()
    P = tracks.shape[0]
    cols = point_colors(P)
    for t in range(frames.shape[0]):
        for p in range(P):
            for s in range(max(0, t - tail), t):
                a, b = tracks[p, s], tracks[p, s + 1]
                if min(a.min(), b.min()) < 0:
                    continue
                draw_line(out[t], (int(a[0]), int(a[1])), (int(b[0]), int(b[1])), cols[p])
    return out


def correspondence_overlay(img1: np.ndarray, img2: np.ndarray,
                           matches_xy: np.ndarray) -> np.ndarray:
    """Side-by-side frame pair with a circle at each end of a match and a
    line between them (matches_xy (N, 4): x1, y1, x2, y2)."""
    h = max(img1.shape[0], img2.shape[0])
    canvas = np.zeros((h, img1.shape[1] + img2.shape[1], 3), np.uint8)
    canvas[: img1.shape[0], : img1.shape[1]] = img1
    canvas[: img2.shape[0], img1.shape[1]:] = img2
    off = img1.shape[1]
    cols = point_colors(len(matches_xy))
    for i, (x1, y1, x2, y2) in enumerate(matches_xy):
        a, b = (int(x1), int(y1)), (int(x2) + off, int(y2))
        fill_circle(canvas, a, 2, cols[i])
        fill_circle(canvas, b, 2, cols[i])
        draw_line(canvas, a, b, cols[i])
    return canvas


def mask_overlay(frames: np.ndarray, masks: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Colorize propagated VOS label maps (T, H, W; 0 background) over the
    frames, blended in float32."""
    num_objects = int(masks.max())
    colors = point_colors(max(num_objects, 1))
    out = frames.astype(np.float32).copy()
    for obj in range(1, num_objects + 1):
        sel = masks == obj
        c = colors[obj - 1].astype(np.float32)
        out[sel] = (1 - alpha) * out[sel] + alpha * c
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------- #
# MP4 (Motion-JPEG samples) and still images
# ---------------------------------------------------------------------- #
def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def _descriptor(tag: int, body: bytes) -> bytes:
    n = len(body)  # MPEG-4 expandable size, four bytes as FFmpeg writes it
    size = bytes([0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F,
                  n & 0x7F])
    return bytes([tag]) + size + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
MOVIE_TIMESCALE = 1000


def mp4_mjpeg(samples: List[bytes], width: int, height: int, fps: float) -> bytes:
    """An ISO-BMFF file of JPEG samples, one chunk, `fps` frames a second."""
    n = len(samples)
    scale, delta = int(round(fps * 1000)), 1000
    movie_ms = int(round(n * 1000 / fps))
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
    mdat_head = struct.pack(">I", 8 + sum(len(s) for s in samples)) + b"mdat"
    if len(ftyp) + len(mdat_head) + sum(len(s) for s in samples) >= 1 << 32:
        raise ValueError("the video exceeds the 4 GiB a 32-bit chunk offset can address")
    data_at = len(ftyp) + len(mdat_head)
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, MOVIE_TIMESCALE, movie_ms),
                     struct.pack(">IH", 0x10000, 0x100), bytes(10), _MATRIX, bytes(24),
                     struct.pack(">I", 2))
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_ms), bytes(8),
                     struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                     struct.pack(">II", width << 16, height << 16))
    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, scale, n * delta),
                     struct.pack(">HH", 0x55C4, 0))  # language 'und'
    hdlr = _full_box(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\0")
    esds = _full_box(b"esds", 0, 0, _descriptor(3, struct.pack(">HB", 1, 0) + _descriptor(
        4, bytes([0x6C, 0x11]) + struct.pack(">I", max(len(s) for s in samples))[1:]
        + struct.pack(">II", 0, 0)) + _descriptor(6, b"\x02")))
    mp4v = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1), bytes(32),
                struct.pack(">Hh", 0x18, -1), esds)
    stbl = _box(b"stbl",
                _full_box(b"stsd", 0, 0, struct.pack(">I", 1), mp4v),
                _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta)),
                _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
                _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n),
                          struct.pack(f">{n}I", *(len(s) for s in samples))),
                _full_box(b"stco", 0, 0, struct.pack(">II", 1, data_at)))
    minf = _box(b"minf", _full_box(b"vmhd", 0, 1, bytes(8)),
                _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                        _full_box(b"url ", 0, 1))), stbl)
    moov = _box(b"moov", mvhd, _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf)))
    return b"".join([ftyp, mdat_head, *samples, moov])


def save_video(frames: np.ndarray, path: str, fps: int = 24) -> None:
    """Write (T, H, W, 3) uint8 RGB frames to an ``.mp4`` of Motion-JPEG
    samples (encode_jpeg at quality 95, 4:4:4), which data_io.video's
    VideoReader and cli.demo --video read back.  Other extensions raise
    ValueError: ``.gif`` needs a palette quantiser (PIL's) and other
    containers a video encoder, neither of which the port has."""
    if not path.lower().endswith(".mp4"):
        raise ValueError(
            f"{path}: the port writes .mp4 (Motion-JPEG) only; .gif needs a palette "
            "quantiser (PIL's) and other formats a video encoder, neither of which it has")
    frames = np.asarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[0] == 0 or frames.shape[3] != 3:
        raise ValueError(f"save_video needs (T >= 1, H, W, 3) frames, got {frames.shape}")
    samples = [encode_jpeg(f, JPEG_QUALITY, sampling="444") for f in frames]
    with open(path, "wb") as f:
        f.write(mp4_mjpeg(samples, frames.shape[2], frames.shape[1], fps))


class Mp4Video(NamedTuple):
    samples: List[bytes]  # the JPEG samples in order
    width: int
    height: int
    fps: float


def _boxes(buf: bytes, lo: int, hi: int):
    while lo + 8 <= hi:
        size, kind = struct.unpack_from(">I4s", buf, lo)
        if size < 8 or lo + size > hi:
            raise ValueError(f"corrupt MP4 box {kind!r} at {lo}")
        yield kind, lo + 8, lo + size
        lo += size


def _child(buf: bytes, lo: int, hi: int, path: List[bytes]) -> Tuple[int, int]:
    for kind, a, b in _boxes(buf, lo, hi):
        if kind == path[0]:
            return (a, b) if len(path) == 1 else _child(buf, a, b, path[1:])
    raise ValueError(f"MP4 without {b'/'.join(path).decode()}")


def read_mp4(path: str) -> Mp4Video:
    """The samples, size and rate of an MP4 that save_video wrote (one
    video track of Motion-JPEG samples, one chunk)."""
    with open(path, "rb") as f:
        buf = f.read()
    moov = _child(buf, 0, len(buf), [b"moov"])
    mdia = _child(buf, *moov, [b"trak", b"mdia"])
    a, _ = _child(buf, *mdia, [b"mdhd"])
    scale = struct.unpack_from(">I", buf, a + 12)[0]
    stbl = _child(buf, *mdia, [b"minf", b"stbl"])
    a, _ = _child(buf, *stbl, [b"stsd"])
    entry, ea, _ = next(_boxes(buf, a + 8, len(buf)))
    if entry != b"mp4v":
        raise ValueError(f"{path}: sample entry {entry!r}, not the writer's mp4v")
    width, height = struct.unpack_from(">HH", buf, ea + 24)
    a, _ = _child(buf, *stbl, [b"stts"])
    count, delta = struct.unpack_from(">II", buf, a + 8)
    a, _ = _child(buf, *stbl, [b"stsz"])
    n = struct.unpack_from(">I", buf, a + 8)[0]
    sizes = struct.unpack_from(f">{n}I", buf, a + 12)
    a, _ = _child(buf, *stbl, [b"stco"])
    at = struct.unpack_from(">I", buf, a + 8)[0]
    samples = []
    for s in sizes:
        samples.append(buf[at:at + s])
        at += s
    return Mp4Video(samples, width, height, scale / delta)


def read_video(path: str) -> Tuple[np.ndarray, float]:
    """(T, H, W, 3) uint8 RGB frames and the rate of a save_video file."""
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg_batch

    mp4 = read_mp4(path)
    return decode_jpeg_batch(mp4.samples, n_threads=1), mp4.fps


def png_bytes(img: np.ndarray, palette: Optional[np.ndarray] = None) -> bytes:
    """An 8-bit PNG (filter 0 rows, zlib level 1): (H, W, 3) uint8 RGB,
    (H, W) uint8 grey, or (H, W) uint8 indices into `palette` ((n, 3) uint8
    RGB)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0 if palette is None else 3

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    parts = [b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))]
    if color == 3:
        parts.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    parts += [chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)), chunk(b"IEND", b"")]
    return b"".join(parts)


def save_image(rgb: np.ndarray, path: str) -> None:
    """Write an (H, W, 3) uint8 RGB image as ``.png`` or ``.jpg``/``.jpeg``
    (encode_jpeg at quality 95, the bytes cv2.imwrite writes); other
    extensions raise ValueError."""
    low = path.lower()
    if low.endswith(".png"):
        data = png_bytes(rgb)
    elif low.endswith((".jpg", ".jpeg")):
        data = encode_jpeg(np.asarray(rgb, np.uint8), JPEG_QUALITY)
    else:
        raise ValueError(f"{path}: the port writes still images as .png or .jpg only")
    with open(path, "wb") as f:
        f.write(data)
