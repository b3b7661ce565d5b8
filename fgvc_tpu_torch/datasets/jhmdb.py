"""JHMDB pose keypoints: reader, reference heatmaps, PCK evaluation
(fgvc_tpu/datasets/jhmdb.py).

* ``{list_path}/{split}_list.txt`` lines: "<annotation .mat> <video dir>",
  both relative to the root;
* frames: the video directory's ``*.png``, sorted; ground truth ``pos_img``
  (2, 15, T) in the .mat, 1-based (minus 1 on load, through scipy.io);
* reference heatmaps: 3-sigma truncated gaussians (sigma 4, peak 1) drawn at
  the ORIGINAL frame size; the frames are resized to the input size (320 x
  320, image_io.resize_frames), the maps are not (the tracker resizes them
  to feature resolution);
* PCK@alpha normalised by 0.6 x the visible joints' box diagonal
  (core/metrics/pck.jhmdb_pck), predictions at the original size.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence

import numpy as np

from fgvc_tpu_torch.core.metrics.pck import JHMDB_NUM_KEYPOINTS, jhmdb_pck
from fgvc_tpu_torch.datasets.image_io import read_image, resize_frames

NUM_KEYPOINTS = JHMDB_NUM_KEYPOINTS


def draw_truncated_gaussian(img: np.ndarray, pt, sigma: float) -> np.ndarray:
    """Write a 3-sigma truncated gaussian patch (peak 1) centred at pt = (x,
    y) into `img` in place: the patch overwrites (no max), a patch wholly
    outside the image writes nothing."""
    ul = [int(pt[0] - 3 * sigma), int(pt[1] - 3 * sigma)]
    br = [int(pt[0] + 3 * sigma + 1), int(pt[1] + 3 * sigma + 1)]
    if ul[0] >= img.shape[1] or ul[1] >= img.shape[0] or br[0] < 0 or br[1] < 0:
        return img
    size = int(6 * sigma + 1)
    x = np.arange(0, size, 1, float)
    y = x[:, np.newaxis]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2))
    g_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    img_x = max(0, ul[0]), min(br[0], img.shape[1])
    img_y = max(0, ul[1]), min(br[1], img.shape[0])
    img[img_y[0]:img_y[1], img_x[0]:img_x[1]] = g[g_y[0]:g_y[1], g_x[0]:g_x[1]]
    return img


def draw_keypoint_maps(coords_xy: np.ndarray, height: int, width: int,
                       sigma: float = 4.0) -> np.ndarray:
    """(P, 2) (x, y) -> (height, width, P) float32 truncated-gaussian maps
    (sigma > 0) or single-pixel impulses (sigma <= 0)."""
    P = coords_xy.shape[0]
    maps = np.zeros((height, width, P), dtype=np.float32)
    for j in range(P):
        if sigma > 0:
            draw_truncated_gaussian(maps[:, :, j], coords_xy[j], sigma)
        else:
            tx, ty = int(coords_xy[j, 0]), int(coords_xy[j, 1])
            if 0 <= tx < width and 0 <= ty < height:
                maps[ty, tx, j] = 1.0
    return maps


class JhmdbDataset:
    """JHMDB videos for keypoint propagation."""

    def __init__(self, root: str, list_path: str, split: str = "val", sigma: float = 4.0,
                 input_size=(320, 320)):
        self.root = root
        self.sigma = sigma
        self.input_size = tuple(input_size)
        self.samples: List[Dict] = []
        with open(os.path.join(list_path, f"{split}_list.txt")) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) != 2:
                    continue
                anno, vname = parts
                frames = sorted(glob.glob(os.path.join(root, vname, "*.png")))
                if frames:
                    self.samples.append({
                        "frames_path": frames,
                        "anno_path": os.path.join(root, anno),
                        "video_path": os.path.join(root, vname),
                        "num_frames": len(frames),
                    })

    def __len__(self):
        return len(self.samples)

    def load_gt_poses(self, idx: int) -> np.ndarray:
        """(2, 15, T) zero-based (x; y) keypoints."""
        import scipy.io as sio

        return sio.loadmat(self.samples[idx]["anno_path"])["pos_img"] - 1

    def __getitem__(self, idx: int) -> Dict:
        sample = self.samples[idx]
        frames = np.stack([read_image(p) for p in sample["frames_path"]])
        original_shape = frames.shape[1:3]
        gt = self.load_gt_poses(idx)  # (2, 15, T)
        ref_maps = draw_keypoint_maps(gt[:, :, 0].T, *original_shape, sigma=self.sigma)
        return {
            "video": resize_frames(frames, self.input_size),  # (T, 320, 320, 3) uint8
            "ref_maps": ref_maps,                              # (H0, W0, 15), original size
            "original_shape": original_shape,
            "gt_poses": gt,
        }

    def evaluate(self, pred_poses_list: Sequence[np.ndarray], indices=None,
                 output_dir=None) -> Dict[str, float]:
        """pred_poses_list: per video (2, 15, T) coordinates at the original
        size; `indices` the dataset index of each (default 0, 1, ...).  Both
        sides are cut to the shorter length."""
        if indices is None:
            indices = range(len(pred_poses_list))
        gts = [self.load_gt_poses(i) for i in indices]
        gts = [g[:, :, :min(g.shape[-1], p.shape[-1])] for g, p in zip(gts, pred_poses_list)]
        preds = [p[:, :, :g.shape[-1]] for p, g in zip(pred_poses_list, gts)]
        results = jhmdb_pck(preds, gts)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            with open(os.path.join(output_dir, "result.txt"), "a") as f:
                for k, v in results.items():
                    f.write(f"{k}: {v}\n")
        return results
