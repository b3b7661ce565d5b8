"""BADJA animal keypoints: DAVIS full-resolution videos with SMAL joints
(fgvc_tpu/datasets/badja.py).

* one JSON per animal in ``{list_path}/joint_annotations/``: a list of
  {image_path, segmentation_path, joints (y, x), visibility} on some of its
  frames; the video spans the first to the last annotated frame, its frames
  and segmentations read from ``{root}/JPEGImages/Full-Resolution`` and
  ``Annotations/Full-Resolution``; animals of ``extra_videos`` are skipped;
* the 20 annotated SMAL joints (ANNOTATED_CLASSES);
* frames resized to (320, 512) (image_io.resize_frames); the reference
  heatmaps drawn at 1/scale of that with truncated sigma-3 gaussians;
* PCK@alpha with threshold alpha * sqrt(mask area) over visible joints; the
  segmentation is read as cv2.imread(IMREAD_UNCHANGED) reads it (a palette
  PNG expands to three colour channels, and the area counts non-zero
  channel values, as the JAX reader's), nearest-resized to the frame size,
  then to (320, 512).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from fgvc_tpu_torch.core.metrics.pck import badja_pck
from fgvc_tpu_torch.datasets.image_io import read_image, resize_frames, resize_nearest
from fgvc_tpu_torch.datasets.jhmdb import draw_keypoint_maps

# the 20 annotated indices of the SMAL joint catalog
ANNOTATED_CLASSES = np.array(
    [8, 9, 10, 12, 13, 14, 15, 18, 19, 20, 22, 23, 24, 25, 28, 31, 32, 33, 35, 36]
)


class BadjaDataset:
    def __init__(self, root: str, list_path: str, size=(320, 512), sigma: float = 3.0,
                 scale: int = 2, length: int = -1):
        self.root = root
        self.size = tuple(size)
        self.sigma = sigma
        self.scale = scale
        self.length = length
        self.videos: List[Dict] = []
        anno_dir = os.path.join(list_path, "joint_annotations")
        for name in sorted(os.listdir(anno_dir)):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(anno_dir, name)) as f:
                data = json.load(f)
            first = data[0]["segmentation_path"]
            if "extra_videos" in first:
                continue
            animal = first.split("/")[-2]
            lo = int(first.split("/")[-1].split(".")[0])
            hi = int(data[-1]["segmentation_path"].split("/")[-1].split(".")[0])
            # the JSON's paths start with 'badja/', relative to the root's parent
            by_image = {os.path.join(root, e["image_path"][6:]): e for e in data}
            frames, segs, joints, vis = [], [], [], []
            for fr in range(lo, hi + 1):
                img = os.path.join(root, "JPEGImages/Full-Resolution/%s/%05d.jpg" % (animal, fr))
                seg = os.path.join(root, "Annotations/Full-Resolution/%s/%05d.png" % (animal, fr))
                e = by_image.get(img)
                j = v = None
                if e is not None:
                    seg = os.path.join(root, e["segmentation_path"][6:])
                    j = np.array(e["joints"])[ANNOTATED_CLASSES]
                    v = np.array(e["visibility"])[ANNOTATED_CLASSES]
                frames.append(img)
                segs.append(seg)
                joints.append(j)
                vis.append(v)
            if frames:
                self.videos.append(dict(frames=frames, segs=segs, joints=joints, visibles=vis))

    def __len__(self):
        return len(self.videos)

    def _load_video(self, idx: int):
        """(frames, segmentations at the frame size, joints, visibilities)."""
        v = self.videos[idx]
        rgbs, segs = [], []
        for img_p, seg_p in zip(v["frames"], v["segs"]):
            rgb = read_image(img_p)
            rgbs.append(rgb)
            segs.append(resize_nearest(read_image(seg_p, "unchanged"), rgb.shape[:2]))
        return rgbs, segs, v["joints"], v["visibles"]

    def __getitem__(self, idx: int) -> Dict:
        rgbs, _, joints, _ = self._load_video(idx)
        h0, w0 = rgbs[0].shape[:2]
        H, W = self.size
        frames = resize_frames(np.stack(rgbs), self.size)
        if self.length != -1:
            frames = frames[:self.length]
        # frame 0's joints, (y, x), scaled to the input, then to the 1/scale grid
        ref = joints[0].astype(np.float64).copy()
        ref[:, 0] *= H / h0
        ref[:, 1] *= W / w0
        coords_xy = np.stack([ref[:, 1], ref[:, 0]], axis=-1) / self.scale
        ref_maps = draw_keypoint_maps(coords_xy, H // self.scale, W // self.scale,
                                      sigma=self.sigma)
        return {
            "video": frames,                 # (T, 320, 512, 3) uint8
            "ref_maps": ref_maps,            # (160, 256, P)
            "original_shape": self.size,     # the decode resolution
            "num_points": ref_maps.shape[-1],
        }

    def evaluate(self, pred_coords_list: Sequence[np.ndarray], indices=None,
                 output_dir=None) -> Dict[str, float]:
        """pred_coords_list: per video (T, P, 2) (x, y) at `size`; `indices`
        the dataset index of each (default 0, 1, ...)."""
        if indices is None:
            indices = range(len(pred_coords_list))
        per_frame = []
        H, W = self.size
        for idx, pred in zip(indices, pred_coords_list):
            rgbs, segs, joints, visibles = self._load_video(idx)
            h0, w0 = rgbs[0].shape[:2]
            n = len(rgbs) if self.length == -1 else min(self.length, len(rgbs))
            for t in range(n):
                if joints[t] is None:
                    continue
                j = joints[t].astype(np.float64).copy()
                j[:, 0] *= H / h0
                j[:, 1] *= W / w0
                per_frame.append({
                    "pred": pred[t],
                    "gt": np.stack([j[:, 1], j[:, 0]], axis=-1),
                    "visible": visibles[t],
                    "mask_area": (resize_nearest(segs[t], self.size) > 0).sum(),
                })
        results = badja_pck(per_frame)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            with open(os.path.join(output_dir, "result.txt"), "a") as f:
                for k, v in results.items():
                    f.write(f"{k}: {v}\n")
        return results
