"""Image reading and resizing of the port's readers, in numpy.

``resize_frames`` and ``resize_nearest`` equal cv2.resize with INTER_LINEAR
(uint8) and INTER_NEAREST bit for bit, so the readers give the JAX
package's arrays without cv2, which the card's machine lacks.
``read_image`` decodes a PNG or JPEG file (or its bytes) through PIL as
cv2.imread would return it; where PIL is missing it raises ImportError.
"""

from __future__ import annotations

import io
from typing import Tuple, Union

import numpy as np


def pil_image():
    """PIL.Image, or an ImportError that says what reads without it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding PNG and JPEG images needs PIL (Pillow), which is not "
            "installed; decoding without it is ROADMAP.md Queue 1 item 43"
        ) from e
    return Image


def read_image(src: Union[str, bytes], flags: str = "color") -> np.ndarray:
    """Decode an image file (a path, or its bytes) as cv2.imread does.

    flags 'color': (H, W, 3) uint8 RGB, what cv2.cvtColor(cv2.imread(p),
    cv2.COLOR_BGR2RGB) gives.  flags 'unchanged': what cv2.imread(p,
    cv2.IMREAD_UNCHANGED) gives, channels in BGR order: a grey image as
    (H, W), a palette image expanded through its palette to 3 channels (4
    where the palette has transparency), RGB as BGR and RGBA as BGRA; 16-bit
    grey stays uint16."""
    if flags not in ("color", "unchanged"):
        raise ValueError(f"flags must be 'color' or 'unchanged', got {flags!r}")
    Image = pil_image()
    with Image.open(io.BytesIO(src) if isinstance(src, bytes) else src) as im:
        if flags == "color":
            return np.array(im.convert("RGB"))
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        elif im.mode == "LA":
            im = im.convert("RGBA")
        a = np.array(im)
    if a.ndim == 3:  # RGB(A) -> BGR(A)
        a = a[..., [2, 1, 0, *range(3, a.shape[2])]]
    return np.ascontiguousarray(a)


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
