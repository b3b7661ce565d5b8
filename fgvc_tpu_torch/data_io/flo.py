"""Middlebury .flo optical-flow file IO (fgvc_tpu/data_io/flo.py).

The wire format mmcv.flowread/flowwrite and the reference's flow tooling
use: magic float32 202021.25 ('PIEH'), int32 width, int32 height, then
(h, w, 2) float32 row-major (u, v).  The bytes equal the JAX package's.
"""

from __future__ import annotations

import numpy as np

_MAGIC = 202021.25


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write an (H, W, 2) float flow to a .flo file."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.tofile(f)


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file into an (H, W, 2) float32 array."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)
        if magic.size == 0 or magic[0] != np.float32(_MAGIC):
            raise ValueError(f"{path}: not a .flo file (bad magic {magic})")
        size = np.fromfile(f, np.int32, 2)
        if size.size != 2:
            raise ValueError(f"{path}: truncated header")
        w, h = int(size[0]), int(size[1])
        data = np.fromfile(f, np.float32, h * w * 2)
    if data.size != h * w * 2:
        raise ValueError(f"{path}: truncated ({data.size} of {h * w * 2})")
    return data.reshape(h, w, 2)
