"""RGB -> CIE-Lab, the Lab and ImageNet eval normalisations, and the I420
upload codec (fgvc_tpu/ops/color.py).

Matches cv2.cvtColor(float32 RGB in [0, 1], COLOR_RGB2Lab), including the
sRGB gamma decoding cv2 applies before the D65 XYZ matrix.  Channels-last.

upload_format 'yuv420' halves the bytes a video takes to the device: the
host encodes uint8 RGB frames to I420 planes (rgb_to_yuv420_host, the host
library's rgb_to_i420_batch, equal to cv2.COLOR_RGB2YUV_I420), and the
device decodes them (yuv420_to_rgb01: BT.601 studio swing, nearest chroma
upsampling, as cv2.COLOR_YUV2RGB_I420) before the usual preprocessing.
"""

from __future__ import annotations

import numpy as np
import torch

# D65 reference white, OpenCV constants.
_XN = 0.950456
_ZN = 1.088754

_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)

# The Lab normalisation of every shipped eval config.
LAB_MEAN = (50.0, 0.0, 0.0)
LAB_STD = (50.0, 127.0, 127.0)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt; pow(1/3) is NaN below 0, so clamp first (the
    # callers select this branch only for t > 0.008856)
    return torch.clamp_min(t, 0.0).pow(1.0 / 3.0)


def _f(t: torch.Tensor) -> torch.Tensor:
    """CIE Lab forward curve: cube root above the knee, linear below."""
    return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Inverse sRGB companding, as cv2's float path applies it."""
    return torch.where(
        c > 0.04045, ((torch.clamp_min(c, 0.0) + 0.055) / 1.055) ** 2.4, c / 12.92
    )


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0, 1] -> Lab (L in [0, 100], a/b about +-127)."""
    rgb = _srgb_to_linear(rgb)
    m = torch.tensor(_RGB2XYZ, dtype=rgb.dtype, device=rgb.device)
    xyz = torch.einsum("...c,dc->...d", rgb, m)
    x = _f(xyz[..., 0] / _XN)
    y = xyz[..., 1]
    fy = _f(y)
    z = _f(xyz[..., 2] / _ZN)
    big_l = torch.where(y > 0.008856, 116.0 * _cbrt(y) - 16.0, 903.3 * y)
    return torch.stack([big_l, 500.0 * (x - fy), 200.0 * (fy - z)], dim=-1)


def normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    """Per-channel (img - mean) / std on channels-last tensors."""
    mean = torch.tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def preprocess_rgb_to_lab_normalized(rgb_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB frame(s) -> normalised Lab float32, the eval preprocessing."""
    lab = rgb_to_lab(rgb_uint8.to(torch.float32) / 255.0)
    return normalize(lab, LAB_MEAN, LAB_STD)


# mmcv's ImageNet img_norm_cfg (mean and std on 0-255, here on 0-1): the
# preprocessing of the DINO / ViT / Swin encoders of the zoo
IMAGENET_MEAN = (123.675 / 255.0, 116.28 / 255.0, 103.53 / 255.0)
IMAGENET_STD = (58.395 / 255.0, 57.12 / 255.0, 57.375 / 255.0)


def preprocess_rgb_to_imagenet(rgb_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB frame(s) -> ImageNet-normalised RGB float32."""
    return normalize(rgb_uint8.to(torch.float32) / 255.0, IMAGENET_MEAN, IMAGENET_STD)


def rgb_to_yuv420_host(video: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) or (H, W, 3) uint8 RGB -> I420 planes (..., H*3//2, W),
    on the host, H and W even: one GIL-free call of the host library."""
    from fgvc_tpu_torch.data_io.fgpack import rgb_to_i420_batch

    return rgb_to_i420_batch(video)


def yuv420_to_rgb01(yuv: torch.Tensor) -> torch.Tensor:
    """I420 planes (..., H*3//2, W) uint8 -> (..., H, W, 3) float32 RGB in
    [0, 1], as cv2.COLOR_YUV2RGB_I420 decodes them: each chroma sample
    covers its 2 x 2 pixels, and the luma excursion is clamped at zero
    before scaling (cv2's fixed-point max(0, Y - 16)).  The U and V planes
    are cut from the flat bytes, so any even H works."""
    *lead, hp, w = yuv.shape
    h = hp * 2 // 3
    flat = yuv.to(torch.float32).reshape(*lead, hp * w)
    n = h * w
    y = flat[..., :n].reshape(*lead, h, w)
    u = flat[..., n:n + n // 4].reshape(*lead, h // 2, w // 2)
    v = flat[..., n + n // 4:n + n // 2].reshape(*lead, h // 2, w // 2)
    u = u.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) - 128.0
    v = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) - 128.0
    yy = 1.16438356 * torch.clamp_min(y - 16.0, 0.0)
    r = yy + 1.59602679 * v
    g = yy - 0.39176229 * u - 0.81296765 * v
    b = yy + 2.01723214 * u
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0) / 255.0


def preprocess_yuv420_to_lab_normalized(yuv: torch.Tensor) -> torch.Tensor:
    """I420 uint8 frame(s) -> normalised Lab float32 (decode, then the eval
    preprocessing)."""
    return normalize(rgb_to_lab(yuv420_to_rgb01(yuv)), LAB_MEAN, LAB_STD)


def preprocess_yuv420_to_imagenet(yuv: torch.Tensor) -> torch.Tensor:
    """I420 uint8 frame(s) -> ImageNet-normalised RGB float32."""
    return normalize(yuv420_to_rgb01(yuv), IMAGENET_MEAN, IMAGENET_STD)


def preprocess_fns(preprocess: str):
    """(from RGB, from I420 planes): the uint8 -> float32 preprocessing of
    TestConfig.preprocess for each upload format."""
    if preprocess == "imagenet":
        return preprocess_rgb_to_imagenet, preprocess_yuv420_to_imagenet
    if preprocess == "lab":
        return preprocess_rgb_to_lab_normalized, preprocess_yuv420_to_lab_normalized
    raise ValueError(f"preprocess must be 'lab' or 'imagenet', got {preprocess!r}")


def preprocess_fn(preprocess: str):
    """The uint8 RGB -> float32 preprocessing of TestConfig.preprocess."""
    return preprocess_fns(preprocess)[0]
