"""RGB -> CIE-Lab and the eval normalisation (fgvc_tpu/ops/color.py).

Matches cv2.cvtColor(float32 RGB in [0, 1], COLOR_RGB2Lab), including the
sRGB gamma decoding cv2 applies before the D65 XYZ matrix.  Channels-last.
"""

from __future__ import annotations

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
