"""DAVIS-2017 semi-supervised VOS dataset: frames, first-frame masks and J&F
scoring (fgvc_tpu/datasets/davis_vos.py).

Every video is resized to 480 x 880 whatever the configuration's input size,
as the JAX harness does.  JPEG frames and palette PNG annotations are
decoded with PIL; where PIL is missing, reading a video raises ImportError.
Frames are resized as cv2.resize(..., INTER_LINEAR) resizes uint8 images, bit
for bit, in numpy's integer arithmetic (the card's machine has no cv2).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fgvc_tpu_torch.core.metrics.vos import aggregate_jf, evaluate_video_jf

INPUT_SIZE = (480, 880)


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading DAVIS frames and palette PNG annotations needs PIL "
            "(Pillow), which is not installed"
        ) from e
    return Image


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
        return np.array(_pil_image().open(path))

    def __getitem__(self, idx: int) -> Dict:
        Image = _pil_image()
        seq = self.sequences[idx]
        frames = np.stack([
            np.array(Image.open(p).convert("RGB")) for p in self._frame_paths(seq)
        ])
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
