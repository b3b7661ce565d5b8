"""Data of the mixed training recipe (fgvc_tpu/datasets/flyingthings_ytv.py):
samples in the protocol the mixed loss consumes, float32 and channels-last:

    imgs (2, H, W, 3)      the unlabeled pair, Lab-normalised
    imgs_sup (2, H, W, 3)  the flow-labeled pair, [frame 1, frame 0]
    flow (H, W, 2)         frame 0 -> frame 1 ("into future" at frame 0)
    flow_back (H, W, 2)    frame 1 -> frame 0

* `FlyingThingsYtvDataset`: the paper's data, YouTube-VOS frame pairs
  (`UnsupPipeline`: random resized crop, resize, flip, blur) beside
  FlyingThings3D cleanpass pairs with their PFM flows (`SupPipeline`:
  crop, blur), read without PIL or cv2 (`image_io.read_image`,
  `read_flow_pfm`; the cv2-exact `resize_frames` and `gaussian_blur`);
* `StructuredSyntheticMixedDataset`: textured scenes with textured square
  sprites under known translations, so the flow is exact;
* `MoviMixedDataset`: the unlabeled pair from MOVi-style scene videos
  (tools/data/generate_movi.py pickles), the labeled pair procedural;
* `SyntheticMixedDataset`: iid noise, for smoke runs.

Every sample is a function of (seed, index) alone, so `make_batches(...,
skip=n)` resumes the data stream exactly.  The Lab conversion is the port's
own (ops/color.py, cv2's float path).
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fgvc_tpu_torch.datasets.image_io import gaussian_blur, read_image, resize_frames
from fgvc_tpu_torch.ops.color import preprocess_rgb_to_lab_normalized


def rgb_to_lab_normalized(img_uint8: np.ndarray) -> np.ndarray:
    """uint8 RGB (..., 3) -> Lab, normalised by LAB_MEAN / LAB_STD."""
    return preprocess_rgb_to_lab_normalized(torch.from_numpy(np.ascontiguousarray(img_uint8))).numpy()


def read_pfm(path: str) -> np.ndarray:
    """A PFM file (FlyingThings3D's flow format) as float32: 'PF' (H, W, 3)
    or 'Pf' (H, W), '#' comment lines skipped, a negative scale little
    endian and a positive one big endian, rows flipped to top-down.  A
    malformed header or short data raises ValueError."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().decode("latin-1")
        while dims.startswith("#"):
            dims = f.readline().decode("latin-1")
        m = re.match(r"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"malformed PFM dims in {path}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").strip())
        body = f.read()
    shape = (h, w, 3) if header == "PF" else (h, w)
    data = np.frombuffer(body, ("<" if scale < 0 else ">") + "f4")
    if data.size != int(np.prod(shape)):
        raise ValueError(f"{path}: {data.size} floats for a {w} x {h} PFM")
    return np.flipud(data.reshape(shape)).astype(np.float32)


def read_flow_pfm(path: str) -> np.ndarray:
    """(H, W, 2) float32 flow from a FlyingThings PFM (third channel dropped)."""
    data = read_pfm(path)
    return np.ascontiguousarray(data[:, :, :2] if data.ndim == 3 else data)


def random_resized_crop_params(rng: np.random.Generator, h: int, w: int,
                               area_range=(0.6, 1.0),
                               aspect_range=(1.5, 2.0)) -> Tuple[int, int, int, int]:
    """(y, x, ch, cw): a crop of area_range of the frame at an aspect in
    aspect_range, its sides swapped half the time; up to 10 draws, then the
    centred square.  The draws are the JAX package's, call for call."""
    for _ in range(10):
        area = rng.uniform(*area_range) * h * w
        aspect = rng.uniform(*aspect_range)
        cw = int(round(np.sqrt(area * aspect)))
        ch = int(round(np.sqrt(area / aspect)))
        if rng.random() < 0.5:
            cw, ch = ch, cw
        if cw <= w and ch <= h:
            y = rng.integers(0, h - ch + 1)
            x = rng.integers(0, w - cw + 1)
            return int(y), int(x), ch, cw
    s = min(h, w)
    return (h - s) // 2, (w - s) // 2, s, s


class UnsupPipeline:
    """The YouTube-VOS branch: one random resized crop of both frames,
    resized to out_size (cv2-exact INTER_LINEAR), flipped with p 0.5,
    blurred with p blur_p at sigma in [0.1, 2], Lab-normalised.  The rng
    draws crop, flip, blur flag, sigma, as the JAX pipeline does."""

    def __init__(self, out_size: int = 256, blur_p: float = 0.8):
        self.out_size = out_size
        self.blur_p = blur_p

    def __call__(self, frames: List[np.ndarray], rng: np.random.Generator) -> np.ndarray:
        h, w = frames[0].shape[:2]
        y, x, ch, cw = random_resized_crop_params(rng, h, w)
        flip = rng.random() < 0.5
        do_blur = rng.random() < self.blur_p
        sigma = rng.uniform(0.1, 2.0) if do_blur else 0.0
        crops = np.stack([f[y:y + ch, x:x + cw] for f in frames])
        out = resize_frames(crops, (self.out_size, self.out_size))
        if flip:
            out = out[:, :, ::-1]
        if do_blur:
            out = np.stack([gaussian_blur(f, sigma) for f in out])
        return rgb_to_lab_normalized(out)  # (2, S, S, 3)


class SupPipeline:
    """The FlyingThings branch: one random crop x crop window of the frames
    and both flows (flow values kept: a crop keeps pixel units), the frames
    blurred with p blur_p at sigma in [0.1, 2], Lab-normalised.  The rng
    draws y, x, blur flag, sigma."""

    def __init__(self, crop: int = 256, blur_p: float = 0.8):
        self.crop = crop
        self.blur_p = blur_p

    def __call__(self, frames, flow, flow_back, rng: np.random.Generator):
        h, w = frames[0].shape[:2]
        c = self.crop
        y = int(rng.integers(0, max(h - c, 0) + 1))
        x = int(rng.integers(0, max(w - c, 0) + 1))
        do_blur = rng.random() < self.blur_p
        sigma = rng.uniform(0.1, 2.0) if do_blur else 0.0
        imgs = np.stack([f[y:y + c, x:x + c] for f in frames])
        if do_blur:
            imgs = np.stack([gaussian_blur(f, sigma) for f in imgs])
        return (rgb_to_lab_normalized(imgs),
                flow[y:y + c, x:x + c].astype(np.float32),
                flow_back[y:y + c, x:x + c].astype(np.float32))


class FlyingThingsYtvDataset:
    """The mixed training set: each sample pairs one YouTube-VOS clip with
    one FlyingThings3D flow pair.

    * YouTube-VOS: frames under ytv_root/train/JPEGImages_s256/<video>/.
      `ytv_list` is a JSON of {video: [frame files]} or {"videos": {...}}
      whose lists are taken verbatim (the reference's every-5th-frame
      index; a frame it lists that is missing raises FileNotFoundError
      naming the video and the first such frame); without it, or for a
      video without a list, the directory's *.jpg.  Videos of fewer than
      two frames are left out.
    * FlyingThings3D: frames_cleanpass/TRAIN/*/*/left/*.png paired n, n + 1
      with optical_flow/TRAIN/<scene>/into_future/left/
      OpticalFlowIntoFuture_{n:04d}_L.pfm and into_past/left/
      OpticalFlowIntoPast_{n+1:04d}_L.pfm; *.webp frames (the published
      WebP cleanpass) are listed with the PNGs, as the JAX glob does, and
      decoded to libwebp's pixels.
    * Sample idx (the raw draw counter of make_batches): video idx % len,
      every draw from np.random.default_rng((seed, idx)); the labeled pair
      stacked [frame 1, frame 0] with flow = into-future at frame 0 and
      flow_back = into-past at frame 1 (the reference's convention)."""

    def __init__(self, ytv_root: str, flyingthings_root: str, ytv_list: Optional[str] = None,
                 crop: int = 256, seed: int = 0):
        self.crop = crop
        self.seed = seed
        self.unsup_pipe = UnsupPipeline(out_size=crop)
        self.sup_pipe = SupPipeline(crop=crop)

        self.ytv_videos: List[List[str]] = []
        prefix = os.path.join(ytv_root, "train/JPEGImages_s256")
        if ytv_list and os.path.exists(ytv_list):
            with open(ytv_list) as f:
                meta = json.load(f)
            vids = meta.get("videos", meta)
            for vid in sorted(vids):
                entry = vids[vid] if isinstance(vids, dict) else None
                if isinstance(entry, (list, tuple)) and entry:
                    frames = [os.path.join(prefix, vid, name) for name in entry]
                    missing = [p for p in frames if not os.path.exists(p)]
                    if missing:
                        raise FileNotFoundError(
                            f"{ytv_list} lists {len(missing)} frame(s) for video {vid!r} that "
                            f"are missing under {prefix} (first: {missing[0]}); an incomplete "
                            "download or the wrong --ytv-root?")
                else:
                    frames = sorted(glob.glob(os.path.join(prefix, vid, "*.jpg")))
                if len(frames) >= 2:
                    self.ytv_videos.append(frames)
        else:
            for vdir in sorted(glob.glob(os.path.join(prefix, "*"))):
                frames = sorted(glob.glob(os.path.join(vdir, "*.jpg")))
                if len(frames) >= 2:
                    self.ytv_videos.append(frames)

        self.fly_pairs: List[Dict[str, str]] = []
        img_root = os.path.join(flyingthings_root, "frames_cleanpass/TRAIN")
        flow_root = os.path.join(flyingthings_root, "optical_flow/TRAIN")
        for img_dir in sorted(glob.glob(os.path.join(img_root, "*/*/left"))):
            scene = os.path.dirname(os.path.relpath(img_dir, img_root))  # e.g. A/0000
            frames = sorted(glob.glob(os.path.join(img_dir, "*.png"))
                            + glob.glob(os.path.join(img_dir, "*.webp")))
            for i in range(len(frames) - 1):
                n0 = int(os.path.splitext(os.path.basename(frames[i]))[0])
                fwd = os.path.join(flow_root, scene, "into_future/left",
                                   f"OpticalFlowIntoFuture_{n0:04d}_L.pfm")
                bwd = os.path.join(flow_root, scene, "into_past/left",
                                   f"OpticalFlowIntoPast_{n0 + 1:04d}_L.pfm")
                if os.path.exists(fwd) and os.path.exists(bwd):
                    self.fly_pairs.append(dict(f0=frames[i], f1=frames[i + 1], fwd=fwd, bwd=bwd))

        if not self.ytv_videos:
            raise FileNotFoundError(f"no YouTube-VOS videos found under {ytv_root!r}")
        if not self.fly_pairs:
            raise FileNotFoundError(f"no FlyingThings flow pairs found under {flyingthings_root!r}")

    def __len__(self):
        return len(self.ytv_videos)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, idx))
        frames = self.ytv_videos[idx % len(self.ytv_videos)]
        t0 = int(rng.integers(0, len(frames) - 1))
        imgs = self.unsup_pipe([read_image(frames[t]) for t in (t0, t0 + 1)], rng)
        pair = self.fly_pairs[int(rng.integers(0, len(self.fly_pairs)))]
        f0, f1 = read_image(pair["f0"]), read_image(pair["f1"])
        fwd, bwd = read_flow_pfm(pair["fwd"]), read_flow_pfm(pair["bwd"])
        imgs_sup, flow, flow_back = self.sup_pipe([f1, f0], fwd, bwd, rng)
        return {
            "imgs": imgs.astype(np.float32),
            "imgs_sup": imgs_sup.astype(np.float32),
            "flow": flow,
            "flow_back": flow_back,
        }


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


def make_batches(dataset, batch_size: int, steps: int, skip: int = 0, rank: int = 0,
                 world: int = 1):
    """Batches of `batch_size` consecutive samples for steps skip..steps-1;
    `skip` jumps past the first steps' samples without making them, so a
    resumed run sees the batches the uninterrupted run would have.  With
    `world` ranks, `batch_size` is the global batch and this rank makes only
    its slice, samples i + rank * b ... i + (rank + 1) * b - 1 of each global
    batch (b = batch_size // world): every sample is drawn from its index
    alone, so the ranks' slices together are one process's batch
    (check_train_ported refuses a global batch that does not divide)."""
    local = batch_size // world
    i = skip * batch_size + rank * local
    for _ in range(steps - skip):
        samples = [dataset[i + j] for j in range(local)]
        i += batch_size
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
