"""Image reading and resizing of the port's readers, without PIL or cv2.

``read_image`` decodes a JPEG, PNG or WebP file (or its bytes) through the
port's host library (data_io/fgpack.py: its JPEG decoder equals libjpeg's,
its WebP decoder libwebp's, its PNG decoder inflates with zlib and unfilters
natively), as cv2.imread would
return it, the EXIF orientation applied in colour mode;
``read_png_indices`` gives a palette PNG's indices.  ``resize_frames``,
``resize_area`` and ``resize_nearest`` equal cv2.resize with INTER_LINEAR
(uint8), INTER_AREA (uint8, shrinking) and INTER_NEAREST bit for bit,
``gaussian_blur`` cv2.GaussianBlur on uint8.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Tuple, Union

import numpy as np

from fgvc_tpu_torch.data_io.fgpack import (PNG_SIGNATURE, WEBP_MAGIC, decode_jpeg,
                                            decode_jpeg_batch, decode_png, decode_webp,
                                            jpeg_info, webp_info)


def _read(src: Union[str, bytes, os.PathLike]) -> Tuple[bytes, str]:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), "image bytes"
    with open(src, "rb") as f:
        return f.read(), str(src)


def tiff_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of a TIFF header's IFD0, as OpenCV's
    ExifReader reads it: 'II' little endian and anything else big endian,
    the header's 42 checked, IFD0's entries read in order until one lies
    past the data (the entries before it stand).  1 where there is none."""
    order, n = ("<" if tiff[:2] == b"II" else ">"), len(tiff)

    def u(at, size):
        if at + size > n:
            raise IndexError(at)
        return int.from_bytes(tiff[at:at + size], "little" if order == "<" else "big")

    try:
        if u(2, 2) != 42:
            return 1
        at = u(4, 4)
        for e in range(u(at, 2)):
            entry = at + 2 + 12 * e
            if u(entry, 2) == 0x0112:
                return u(entry + 8, 2)
    except IndexError:
        pass
    return 1


def jpeg_exif(data: bytes) -> bytes:
    """The TIFF data of a JPEG's first APP1 segment before its first scan
    (the 6 bytes of 'Exif\\0\\0' skipped unread, as OpenCV does), or b''."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return b""
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            return b""
        length = struct.unpack_from(">H", data, pos + 2)[0]
        if marker == 0xE1:
            body = data[pos + 4:pos + 2 + length]
            return body[6:] if len(body) > 6 else b""
        pos += 2 + length
    return b""


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation transform cv2.imread applies in colour mode:
    2 fliplr, 3 rotate 180, 4 flipud, 5 transpose, 6 rotate 90 clockwise, 7
    transverse, 8 rotate 90 counter-clockwise; other values leave it."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, *range(2, img.ndim))
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def read_image(src: Union[str, bytes, os.PathLike], flags: str = "color") -> np.ndarray:
    """Decode an image file (a path, or its bytes) as cv2.imread does; the
    decoder is chosen by the magic bytes (JPEG FF D8, PNG's signature,
    RIFF....WEBP).

    flags 'color': (H, W, 3) uint8 RGB, what cv2.cvtColor(cv2.imread(p),
    cv2.COLOR_BGR2RGB) gives: grey replicated, a palette expanded, alpha
    dropped, 16-bit samples cut to their high byte, a CMYK JPEG converted
    as OpenCV converts it, and the EXIF orientation (a JPEG's APP1 Exif, a
    PNG's eXIf chunk) applied.  flags 'unchanged': what cv2.imread(p,
    cv2.IMREAD_UNCHANGED) gives, channels in BGR order and the orientation
    ignored: a grey image as (H, W), a palette image expanded through its
    palette to 3 channels (4 where it has tRNS), grey+alpha as BGRA, RGB as
    BGR, RGBA as BGRA and CMYK as BGR; 16-bit PNG samples stay uint16.
    flags 'grayscale': (H, W) uint8, what cv2.imread(p,
    cv2.IMREAD_GRAYSCALE) gives, the orientation applied: a JPEG's Y plane
    (libjpeg's grey output), a colour PNG through libpng's rgb_to_gray, a
    WebP through cvtColor's BGR -> grey.  WebP (lossy, lossless, VP8X)
    decodes to libwebp's pixels: alpha dropped in colour mode, BGRA in
    'unchanged' where the file has alpha (a lossy frame's ALPH plane is
    refused there), the orientation of an EXIF chunk that VP8X flags
    applied in colour and grey mode.  JPEGs the decoder refuses (arithmetic,
    lossless, 12-bit, YCCK), animated WebP and broken files raise
    ValueError."""
    if flags not in ("color", "unchanged", "grayscale"):
        raise ValueError(f"flags must be 'color', 'unchanged' or 'grayscale', got {flags!r}")
    data, name = _read(src)
    if data[:2] == b"\xff\xd8":
        return _read_jpeg(data, name, flags)
    if (data[:4], data[8:12]) == WEBP_MAGIC:
        return _read_webp(data, name, flags)
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: neither a JPEG nor a PNG nor a WebP file")
    png = decode_png(data, name)
    if flags != "unchanged":
        img = _png_rgb(png, name) if flags == "color" else _png_grey(png, name)
        return apply_orientation(img, tiff_orientation(png.exif)) if png.exif else img
    a, ctype = png.samples, png.color_type
    if ctype == 3:  # palette: expand through PLTE (and tRNS)
        idx = _palette_indices(png, name)
        bgr = png.palette[idx][..., ::-1]
        if png.trns is None:
            return np.ascontiguousarray(bgr)
        alpha = np.full(len(png.palette), 255, np.uint8)
        t = np.frombuffer(png.trns, np.uint8)[: len(png.palette)]
        alpha[: len(t)] = t
        return np.ascontiguousarray(np.concatenate([bgr, alpha[idx][..., None]], axis=-1))
    if ctype == 0:
        return np.ascontiguousarray(a[..., 0])
    if ctype == 4:  # grey + alpha -> BGRA
        return np.ascontiguousarray(np.concatenate([np.repeat(a[..., :1], 3, -1), a[..., 1:]], -1))
    return np.ascontiguousarray(a[..., [2, 1, 0, *range(3, a.shape[2])]])


def cmyk_to_bgr(cmyk: np.ndarray) -> np.ndarray:
    """A CMYK JPEG's samples (libjpeg's JCS_CMYK output, Adobe's inverted
    convention) -> BGR as OpenCV's JPEG reader converts them: each of C, M,
    Y becomes k - ((255 - x) * k >> 8)."""
    x = cmyk.astype(np.int32)
    k = x[..., 3:]
    out = k - (((255 - x[..., :3]) * k) >> 8)
    return np.ascontiguousarray(out[..., ::-1].astype(np.uint8))


def _grey14(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's CMYK -> grey of its JPEG reader: the BGR of cmyk_to_bgr at
    14-bit weights 1868, 9617, 4899, rounded."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14).astype(np.uint8)


def _grey15(bgr: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY) on uint8: 15-bit weights 3735,
    19235, 9798, rounded."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


def _read_jpeg(data: bytes, name: str, flags: str) -> np.ndarray:
    """A JPEG as cv2.imread reads it with `flags` (see read_image)."""
    try:
        comps = jpeg_info(data).components
        if comps == 4:
            bgr = cmyk_to_bgr(decode_jpeg_batch([data], layout="cmyk", n_threads=1)[0])
        elif flags != "grayscale":
            bgr = decode_jpeg(data)[..., ::-1]
        if flags == "grayscale":
            img = (_grey14(bgr) if comps == 4
                   else decode_jpeg_batch([data], layout="grey", n_threads=1)[0])
        elif flags == "unchanged":
            img = bgr[..., 0] if comps == 1 else bgr
        else:
            img = bgr[..., ::-1]
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if flags == "unchanged":
        return np.ascontiguousarray(img)
    return apply_orientation(img, tiff_orientation(jpeg_exif(data)))


def _read_webp(data: bytes, name: str, flags: str) -> np.ndarray:
    """A WebP file as cv2.imread reads it: in colour mode RGB, alpha dropped
    and the orientation of an EXIF chunk that VP8X flags applied; in grey
    mode that BGR through cvtColor's grey, oriented; flags 'unchanged' BGR,
    or BGRA where the file has alpha, unrotated."""
    try:
        info = webp_info(data)
        bgr = decode_webp(data, alpha=flags == "unchanged" and info.has_alpha, info=info)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if flags == "unchanged":
        return bgr
    img = bgr[..., ::-1] if flags == "color" else _grey15(bgr)
    return apply_orientation(img, tiff_orientation(info.exif) if info.exif else 1)


def _palette_indices(png, name: str) -> np.ndarray:
    idx = png.samples[..., 0]
    if idx.max(initial=0) >= len(png.palette):
        raise ValueError(f"{name}: palette index beyond PLTE")
    return idx


def _png_rgb(png, name: str) -> np.ndarray:
    """A decoded PNG as (H, W, 3) uint8 RGB, before any orientation."""
    a, ctype = png.samples, png.color_type
    if ctype == 3:
        return np.ascontiguousarray(png.palette[_palette_indices(png, name)])
    if a.dtype == np.uint16:  # libpng's strip_16, as cv2.imread: the high byte
        a = (a >> 8).astype(np.uint8)
    return np.ascontiguousarray(np.repeat(a[..., :1], 3, axis=-1) if ctype in (0, 4) else a[..., :3])


def _png_grey(png, name: str) -> np.ndarray:
    """A decoded PNG as (H, W) uint8, what libpng gives cv2.imread in grey
    mode: grey samples as they are (16-bit cut to the high byte); colour
    and palette samples through png_do_rgb_to_gray at OpenCV's 0.299 and
    0.587, (9797 r + 19234 g + 3737 b) >> 15, truncated for 8-bit samples
    and rounded for 16-bit ones (then cut), an r = g = b sample kept."""
    if png.color_type in (0, 4):
        return np.ascontiguousarray(_png_rgb(png, name)[..., 0])
    rgb = png.palette[_palette_indices(png, name)] if png.color_type == 3 else png.samples
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    wide = rgb.dtype == np.uint16
    grey = (9797 * r + 19234 * g + 3737 * b + (1 << 14 if wide else 0)) >> 15
    grey = np.where((r == g) & (r == b), r, grey)
    return np.ascontiguousarray((grey >> 8 if wide else grey).astype(np.uint8))


def read_png_indices(src: Union[str, bytes, os.PathLike]) -> np.ndarray:
    """A palette PNG's (H, W) uint8 indices (DAVIS's annotations), what
    np.array(PIL.Image.open(p)) gives; an 8-bit grey PNG gives its values.
    Other PNGs raise ValueError."""
    data, name = _read(src)
    png = decode_png(data, name)
    if png.color_type not in (0, 3) or png.bit_depth > 8 or (
            png.color_type == 0 and png.bit_depth != 8):
        raise ValueError(f"{name}: not a palette (or 8-bit grey) PNG")
    return np.ascontiguousarray(png.samples[..., 0])


# cv2's fixed-point bilinear coefficients: 11 fractional bits
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(n_src: int, n_dst: int, clamp: bool):
    """Source indices (i0, i1) and fixed-point weights (w0, w1) of each
    destination index, as cv2's INTER_LINEAR computes them: half-pixel
    centres at scale 1 / (n_dst / n_src) in double, the fraction in float32,
    weights rint((1 - f) * 2048) and rint(f * 2048).  Columns (`clamp`) past
    either edge take the edge pixel at weight (2048, 0); rows keep their
    weights and read the edge row twice."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp:
        edge = (i0 < 0) | (i0 >= n_src - 1)
        f[edge] = 0.0
        i0 = np.clip(i0, 0, n_src - 1)
    i1 = np.clip(i0 + 1, 0, n_src - 1)
    i0 = np.clip(i0, 0, n_src - 1)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    return i0, i1, w0, w1


def resize_frames(frames: np.ndarray, size) -> np.ndarray:
    """(T, H0, W0, C) uint8 -> (T, H, W, C) uint8, equal to cv2.resize(frame,
    (W, H), interpolation=cv2.INTER_LINEAR) frame by frame: a horizontal pass
    in 32-bit integers at 11 fractional bits, then cv2's vectorised vertical
    pass, ((((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >> 16) + 2) >> 2."""
    frames = np.asarray(frames)
    H, W = size
    x0, x1, a0, a1 = _linear_taps(frames.shape[2], W, clamp=True)
    y0, y1, b0, b1 = _linear_taps(frames.shape[1], H, clamp=False)
    a0, a1 = a0[:, None], a1[:, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = np.empty((frames.shape[0], H, W, frames.shape[3]), np.uint8)
    for t, frame in enumerate(frames):
        src = frame.astype(np.int32)
        rows = (src[:, x0] * a0 + src[:, x1] * a1) >> 4  # (H0, W, C)
        v = (((rows[y0] * b0) >> 16) + ((rows[y1] * b1) >> 16) + 2) >> 2
        out[t] = np.clip(v, 0, 255)
    return out


def _area_taps(n_src: int, n_dst: int, scale: float):
    """cv2's computeResizeAreaTab as (m, n_dst) source indices and float32
    weights: the taps of each destination index in cv2's order (the partial
    source pixel before the cell, the whole ones, the partial one after),
    each weight its overlap over min(scale, n_src - start) in double, cast
    to float32; destinations with fewer than m taps are padded with weight
    0, which adds nothing."""
    taps = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s2 = min(math.floor(f2), n_src - 1)
        s1 = min(math.ceil(f1), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    m = max(len(row) for row in taps)
    index = np.zeros((m, n_dst), np.int64)
    weight = np.zeros((m, n_dst), np.float32)
    for d, row in enumerate(taps):
        for k, (s, w) in enumerate(row):
            index[k, d], weight[k, d] = s, np.float32(w)
    return index, weight


def resize_area(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H0, W0[, C]) uint8 -> (H, W[, C]) uint8, equal to cv2.resize(image,
    (W, H), interpolation=cv2.INTER_AREA) bit for bit where neither side
    grows.  Where both scales W0 / W and H0 / H lie within DBL_EPSILON of
    whole numbers, cv2's fast path: integer sums of each cell, (sum + 2) >> 2
    for 2 x 2 cells of 1, 3 or 4 channels, else rint(sum * float32(1 /
    area)).  Otherwise cv2's resizeArea_: each source row's weighted sum
    over the column taps in float32 (_area_taps, in cv2's order), then the
    rows' weighted sum in float32, rounded half to even."""
    image = np.asarray(image)
    H, W = size
    h0, w0 = image.shape[:2]
    if image.dtype != np.uint8:
        raise ValueError(f"resize_area takes uint8 images, got {image.dtype}")
    if not (0 < H <= h0 and 0 < W <= w0):
        raise ValueError(f"resize_area shrinks only: {h0}x{w0} -> {H}x{W}")
    if (H, W) == (h0, w0):
        return image.copy()
    src = image if image.ndim == 3 else image[..., None]
    scale_x, scale_y = 1.0 / (W / w0), 1.0 / (H / h0)
    kx, ky = int(round(scale_x)), int(round(scale_y))
    eps = np.finfo(np.float64).eps
    if abs(scale_x - kx) < eps and abs(scale_y - ky) < eps:
        sums = src.astype(np.int32).reshape(H, ky, W, kx, -1).sum(axis=(1, 3))
        if kx == ky == 2 and src.shape[2] in (1, 3, 4):
            out = (sums + 2) >> 2
        else:
            out = np.rint(sums.astype(np.float32) * (np.float32(1) / np.float32(kx * ky)))
    else:
        xi, xw = _area_taps(w0, W, scale_x)
        yi, yw = _area_taps(h0, H, scale_y)
        pixels = src.astype(np.float32)
        rows = pixels[:, xi[0]] * xw[0][:, None]
        for k in range(1, len(xi)):
            rows = rows + pixels[:, xi[k]] * xw[k][:, None]
        out = rows[yi[0]] * yw[0][:, None, None]
        for k in range(1, len(yi)):
            out = out + rows[yi[k]] * yw[k][:, None, None]
        out = np.rint(out)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out if image.ndim == 3 else out[..., 0]


def gaussian_kernel_q8(sigma: float) -> np.ndarray:
    """cv2.GaussianBlur's kernel for uint8 images at size k = 2 int(4 sigma
    + 0.5) + 1, in OpenCV's fixed point with 8 fractional bits (int64, sum
    256): weights exp(-(i - c)^2 / (2 sigma^2)) in float64 normalised by
    their sum, then rounded by error diffusion from the tails in (half to
    even), the centre 256 minus the rest (getGaussianKernelBitExact and
    getGaussianKernelFixedPoint_ED)."""
    n = 2 * int(4 * sigma + 0.5) + 1
    half = n // 2
    scale2 = -0.125 / (float(sigma) * float(sigma))
    values = [float(np.exp(float((x * x)) * scale2)) for x in range(1 - n, 0, 2)]
    total = 2.0 * sum(values) + 1.0
    mul = 1.0 / total
    out = np.empty(n, np.int64)
    err, acc = 0.0, 0
    for i, v in enumerate(values):
        adj = v * mul * 256.0 + err
        q = int(np.rint(adj))
        err = adj - q
        out[i] = out[n - 1 - i] = q
        acc += q
    out[half] = 256 - 2 * acc
    return out


def _reflect101(n: int, r: int) -> np.ndarray:
    """Source index of each of positions -r .. n - 1 + r under
    BORDER_REFLECT_101, reflected again while past an edge (cv2's
    borderInterpolate; a length of 1 reads index 0)."""
    p = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(p)
    while True:
        low, high = p < 0, p >= n
        if not (low.any() or high.any()):
            return p
        p = np.where(low, -p, np.where(high, 2 * (n - 1) - p, p))


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """(H, W[, C]) uint8 -> the same, equal to cv2.GaussianBlur(img, (k, k),
    sigma) with k = 2 int(4 sigma + 0.5) + 1 bit for bit: the 8-bit
    fixed-point kernel (gaussian_kernel_q8), integer row sums then column
    sums over BORDER_REFLECT_101, then (x + 2^15) >> 16."""
    img = np.asarray(img)
    k = gaussian_kernel_q8(sigma).astype(np.int32)
    r = len(k) // 2
    src = img.astype(np.int32)  # at most 255 * 256 * 256 after both passes
    cols = _reflect101(img.shape[1], r)
    rows = _reflect101(img.shape[0], r)
    h, w = img.shape[:2]
    padded = src[:, cols]
    acc = padded[:, r:r + w] * k[r]
    for j in range(r):
        acc += (padded[:, j:j + w] + padded[:, 2 * r - j:2 * r - j + w]) * k[j]
    padded = acc[rows]
    out = padded[r:r + h] * k[r]
    for j in range(r):
        out += (padded[j:j + h] + padded[2 * r - j:2 * r - j + h]) * k[j]
    return np.clip((out + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def _nearest_index(n_src: int, n_dst: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index of each destination index:
    floor(i * (1 / (n_dst / n_src))) in double, clamped to the last source
    index.  (The integer floor(i * n_src / n_dst) differs from it where the
    double product falls just below a whole number.)"""
    ifx = 1.0 / (n_dst / n_src)
    return np.minimum(np.floor(np.arange(n_dst) * ifx).astype(np.int64), n_src - 1)


def resize_nearest(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H0, W0[, C]) -> (H, W[, C]), equal to cv2.resize(image, (W, H),
    interpolation=cv2.INTER_NEAREST) for any dtype: every output pixel
    copies the source pixel at cv2's index (not the half-pixel
    'nearest-exact' of models/tracker.py's resize_labels)."""
    image = np.asarray(image)
    H, W = size
    return image[_nearest_index(image.shape[0], H)][:, _nearest_index(image.shape[1], W)]
