"""Procedural data of the mixed training recipe
(fgvc_tpu/datasets/flyingthings_ytv.py): samples in the protocol the mixed
loss consumes, float32 and channels-last:

    imgs (2, H, W, 3)      the unlabeled pair, Lab-normalised
    imgs_sup (2, H, W, 3)  the flow-labeled pair, [frame 1, frame 0]
    flow (H, W, 2)         frame 0 -> frame 1 ("into future" at frame 0)
    flow_back (H, W, 2)    frame 1 -> frame 0

* `StructuredSyntheticMixedDataset`: textured scenes with textured square
  sprites under known translations, so the flow is exact;
* `MoviMixedDataset`: the unlabeled pair from MOVi-style scene videos
  (tools/data/generate_movi.py pickles), the labeled pair procedural;
* `SyntheticMixedDataset`: iid noise, for smoke runs.

Every sample is a function of (seed, index) alone, so `make_batches(...,
skip=n)` resumes the data stream exactly.  The Lab conversion is the port's
own (ops/color.py, cv2's float path).  Real YouTube-VOS + FlyingThings3D
data is not ported yet.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List

import numpy as np
import torch

from fgvc_tpu_torch.datasets.davis_vos import resize_frames
from fgvc_tpu_torch.ops.color import preprocess_rgb_to_lab_normalized


def rgb_to_lab_normalized(img_uint8: np.ndarray) -> np.ndarray:
    """uint8 RGB (..., 3) -> Lab, normalised by LAB_MEAN / LAB_STD."""
    return preprocess_rgb_to_lab_normalized(torch.from_numpy(np.ascontiguousarray(img_uint8))).numpy()


def _smooth_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth random RGB texture (sum of low-frequency waves), uint8."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(6):
        fx, fy = rng.uniform(0.02, 0.25, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(15, 50)
        for c in range(3):
            img[..., c] += amp * np.sin(fx * xx + fy * yy + phase[c])
    img += rng.uniform(60, 180, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _sample(f0, f1, g0, g1, flow, flow_back) -> Dict[str, np.ndarray]:
    return {
        "imgs": rgb_to_lab_normalized(np.stack([f0, f1])).astype(np.float32),
        "imgs_sup": rgb_to_lab_normalized(np.stack([g1, g0])).astype(np.float32),
        "flow": flow.astype(np.float32),
        "flow_back": flow_back.astype(np.float32),
    }


class StructuredSyntheticMixedDataset:
    """Frame pairs of a smooth textured background moving by one integer
    translation and `n_sprites` textured squares moving by their own, with
    the exact piecewise-constant flow."""

    def __init__(self, crop: int = 256, length: int = 64, seed: int = 0,
                 max_shift: int = 8, n_sprites: int = 2):
        self.crop = crop
        self.length = length
        self.seed = seed
        self.max_shift = max_shift
        self.n_sprites = n_sprites

    def __len__(self):
        return self.length

    def _scene_pair(self, rng: np.random.Generator):
        s, m = self.crop, self.max_shift
        big = _smooth_texture(rng, s + 2 * m, s + 2 * m)
        d = rng.integers(-m, m + 1, 2)  # background motion (dx, dy)
        f0 = big[m:m + s, m:m + s].copy()
        f1 = big[m - d[1]:m - d[1] + s, m - d[0]:m - d[0] + s].copy()
        flow = np.tile(d.astype(np.float32), (s, s, 1))
        flow_back = -flow.copy()
        for _ in range(self.n_sprites):
            sz = int(rng.integers(s // 8, s // 4))
            tex = _smooth_texture(rng, sz, sz)
            y0 = int(rng.integers(m, s - sz - m))
            x0 = int(rng.integers(m, s - sz - m))
            ds = rng.integers(-m, m + 1, 2)
            y1, x1 = y0 + int(ds[1]), x0 + int(ds[0])
            f0[y0:y0 + sz, x0:x0 + sz] = tex
            f1[y1:y1 + sz, x1:x1 + sz] = tex
            flow[y0:y0 + sz, x0:x0 + sz] = ds
            flow_back[y1:y1 + sz, x1:x1 + sz] = -ds
        return f0, f1, flow, flow_back

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        idx %= self.length  # the raw draw counter cycles `length` scenes
        rng = np.random.default_rng(self.seed + idx)
        f0, f1, _, _ = self._scene_pair(rng)
        return _sample(f0, f1, *self._scene_pair(rng))


class MoviMixedDataset(StructuredSyntheticMixedDataset):
    """The unlabeled pair from MOVi-style scene videos (pickles with a
    (T, H, W, 3) uint8 'video'), two frames up to `max_gap` apart, upscaled
    so the shorter side reaches the crop (cv2-exact bilinear), then cropped;
    the labeled pair and its flow procedural."""

    def __init__(self, movi_dir: str, crop: int = 256, length: int = 64, seed: int = 0,
                 max_shift: int = 8, n_sprites: int = 2, max_gap: int = 4):
        super().__init__(crop, length, seed, max_shift, n_sprites)
        self.clips: List[np.ndarray] = []
        for p in sorted(glob.glob(os.path.join(movi_dir, "*.pkl"))):
            with open(p, "rb") as f:
                v = pickle.load(f)["video"]
            if v.ndim != 4 or v.shape[-1] != 3 or len(v) < 2:
                raise ValueError(f"{p}: expected video (T>=2, H, W, 3), got {v.shape}")
            self.clips.append(v)
        if not self.clips:
            raise FileNotFoundError(f"no MOVi pickles under {movi_dir}")
        self.max_gap = max_gap

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        idx %= self.length
        rng = np.random.default_rng(self.seed + idx)
        v = self.clips[int(rng.integers(len(self.clips)))]
        gap = int(rng.integers(1, min(self.max_gap, len(v) - 1) + 1))
        t = int(rng.integers(0, len(v) - gap))
        pair = np.stack([v[t], v[t + gap]])
        h, w = pair.shape[1:3]
        if h < self.crop or w < self.crop:
            s = self.crop / min(h, w)
            pair = resize_frames(pair, (max(self.crop, round(h * s)), max(self.crop, round(w * s))))
            h, w = pair.shape[1:3]
        y = int(rng.integers(0, h - self.crop + 1))
        x = int(rng.integers(0, w - self.crop + 1))
        f0, f1 = pair[:, y:y + self.crop, x:x + self.crop]
        return _sample(f0, f1, *self._scene_pair(rng))


class SyntheticMixedDataset:
    """Noise in the mixed-training sample protocol (smoke runs)."""

    def __init__(self, crop: int = 256, length: int = 64, seed: int = 0):
        self.crop = crop
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        idx %= self.length
        rng = np.random.default_rng(self.seed + idx)
        s = self.crop
        return {
            "imgs": rng.standard_normal((2, s, s, 3)).astype(np.float32),
            "imgs_sup": rng.standard_normal((2, s, s, 3)).astype(np.float32),
            "flow": (rng.standard_normal((s, s, 2)) * 3).astype(np.float32),
            "flow_back": (rng.standard_normal((s, s, 2)) * 3).astype(np.float32),
        }


def make_batches(dataset, batch_size: int, steps: int, skip: int = 0):
    """Batches of `batch_size` consecutive samples for steps skip..steps-1;
    `skip` jumps past the first steps' samples without making them, so a
    resumed run sees the batches the uninterrupted run would have."""
    i = skip * batch_size
    for _ in range(steps - skip):
        samples = [dataset[i + j] for j in range(batch_size)]
        i += batch_size
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
