"""DAVIS-2017 semi-supervised VOS dataset: frames, first-frame masks and J&F
scoring (fgvc_tpu/datasets/davis_vos.py).

Every video is resized to 480 x 880 whatever the configuration's input size,
as the JAX harness does.  JPEG frames and palette PNG annotations are
decoded with PIL; where PIL is missing, reading a video raises ImportError.
Frames are resized by image_io.resize_frames, which equals cv2's
INTER_LINEAR bit for bit (re-exported here).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fgvc_tpu_torch.core.metrics.vos import aggregate_jf, evaluate_video_jf
from fgvc_tpu_torch.datasets.image_io import pil_image, read_image, resize_frames

INPUT_SIZE = (480, 880)


def score_masks(gt: np.ndarray, pred: np.ndarray):
    """Per-video DAVIS J&F stats of predicted label maps against the
    ground truth, both (T, H, W).

    Protocol: drop frame 0 (given GT) and the LAST GT frame; when the
    prediction stack is truncated mid-video, only the truncation point
    bounds the range (the mid-video 'last' frame is still scored).
    Returns None when no frames remain (e.g. 2-frame smoke runs).
    """
    n = min(len(gt), len(pred))
    num_obj = int(gt.max())
    end = n - 1 if n == len(gt) else n
    if end <= 1:
        return None
    return evaluate_video_jf(gt[1:end], pred[1:end], num_obj)


class DavisVosDataset:
    """DAVIS 2017 val split: frames + first-frame annotation masks."""

    def __init__(
        self,
        root: str,
        split_list: Optional[str] = None,
        resolution: str = "480p",
        input_size=INPUT_SIZE,
    ):
        self.root = root
        self.resolution = resolution
        self.input_size = tuple(input_size)
        if split_list and not os.path.exists(split_list):
            raise FileNotFoundError(
                f"split list {split_list!r} does not exist — refusing to "
                "silently fall back to the default split"
            )
        if split_list:
            with open(split_list) as f:
                if split_list.endswith(".json"):
                    self.sequences = sorted(json.load(f))
                else:
                    self.sequences = sorted(ln.strip() for ln in f if ln.strip())
        else:
            seq_file = os.path.join(root, "ImageSets/2017/val.txt")
            if os.path.exists(seq_file):
                with open(seq_file) as f:
                    self.sequences = sorted(ln.strip() for ln in f if ln.strip())
            else:
                self.sequences = sorted(
                    os.path.basename(p)
                    for p in glob.glob(
                        os.path.join(root, "JPEGImages", resolution, "*")
                    )
                )

    def __len__(self):
        return len(self.sequences)

    def _frame_paths(self, seq: str) -> List[str]:
        return sorted(
            glob.glob(
                os.path.join(self.root, "JPEGImages", self.resolution, seq, "*.jpg")
            )
        )

    def _anno_paths(self, seq: str) -> List[str]:
        return sorted(
            glob.glob(
                os.path.join(self.root, "Annotations", self.resolution, seq, "*.png")
            )
        )

    def load_mask(self, path: str) -> np.ndarray:
        """Palette PNG -> integer label map."""
        return np.array(pil_image().open(path))

    def __getitem__(self, idx: int) -> Dict:
        seq = self.sequences[idx]
        frames = np.stack([read_image(p) for p in self._frame_paths(seq)])
        first_mask = self.load_mask(self._anno_paths(seq)[0])
        return {
            "sequence": seq,
            "video": resize_frames(frames, self.input_size),  # (T, H, W, 3) uint8
            "first_mask": first_mask,            # (H0, W0) labels at original
            "original_shape": frames.shape[1:3],
            "num_objects": int(first_mask.max()),
        }

    def load_gt_masks(self, idx: int) -> np.ndarray:
        seq = self.sequences[idx]
        return np.stack([self.load_mask(p) for p in self._anno_paths(seq)])

    def score_video(self, idx: int, pred: np.ndarray):
        """Per-video DAVIS J&F stats (see score_masks)."""
        return score_masks(self.load_gt_masks(idx), pred)

    def evaluate(
        self,
        pred_masks_list: Sequence[np.ndarray],  # per video (T, H0, W0) labels
        indices=None,
        output_dir=None,
    ) -> Dict[str, float]:
        """DAVIS semi-supervised protocol: score frames [1:-1] per object.

        `indices` gives the dataset index of each prediction (sharded /
        truncated runs); defaults to 0..len(preds)-1.
        """
        if indices is None:
            indices = range(len(pred_masks_list))
        per_video = [
            s
            for idx, pred in zip(indices, pred_masks_list)
            if (s := self.score_video(idx, pred)) is not None
        ]
        results = aggregate_jf(per_video)
        if output_dir:
            write_results(results, output_dir)
        return results


def write_results(results: Dict[str, float], output_dir: str) -> None:
    """Append `key: value` lines to output_dir/result.txt."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "result.txt"), "a") as f:
        for k, v in results.items():
            f.write(f"{k}: {v}\n")
