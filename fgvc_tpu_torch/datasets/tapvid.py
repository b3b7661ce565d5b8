"""TAP-Vid pickles (DAVIS and Kinetics): reader, 'first' and 'strided'
query sampling, evaluation (fgvc_tpu/datasets/tapvid.py).

Each ``*.pkl`` holds one video: {'video': (T, H, W, 3) uint8 or a list of
JPEG byte strings, 'points': (N, T, 2) (x, y) in [0, 1], 'occluded': (N, T)
bool}.  JPEG bytes decode through image_io.read_image (PIL); frames at
another size than the input size are resized as cv2's INTER_LINEAR does
(image_io.resize_frames, bit for bit).
"""

from __future__ import annotations

import csv
import glob
import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from fgvc_tpu_torch.core.metrics.tapvid import (
    aggregate_summaries,
    compute_point_summary,
)
from fgvc_tpu_torch.datasets.image_io import read_image, resize_frames

QUERY_MODES = ("first", "strided")


def sample_queries_first(occluded: np.ndarray, points: np.ndarray) -> Dict:
    """Each track's first visible frame is its query.

    occluded: (N, T) bool, True = occluded; points: (N, T, 2) (x, y).
    Returns query_points (M, 3) as (t, y, x), the TAP-Vid convention, plus
    target_points / occluded of the M tracks visible at least once."""
    valid = (~occluded).sum(axis=1) > 0
    points = points[valid]
    occluded = occluded[valid]
    queries = []
    for i in range(points.shape[0]):
        t = int(np.where(~occluded[i])[0][0])
        x, y = points[i, t]
        queries.append([t, y, x])
    return {
        "query_points": np.array(queries, dtype=np.float32).reshape(-1, 3),
        "target_points": points,
        "occluded": occluded,
    }


def sample_queries_strided(occluded: np.ndarray, points: np.ndarray, stride: int = 5) -> Dict:
    """A query every `stride` frames for each track visible there: the
    queries of frame 0, then of frame `stride`, ...; target_points and
    occluded repeat each query's track."""
    n = occluded.shape[0]
    queries, tracks, occs = [], [], []
    for t in range(0, occluded.shape[1], stride):
        mask = ~occluded[:, t]
        q = np.stack([np.full(n, t, dtype=np.float32), points[:, t, 1], points[:, t, 0]],
                     axis=-1)
        queries.append(q[mask])
        tracks.append(points[mask])
        occs.append(occluded[mask])
    return {
        "query_points": np.concatenate(queries, axis=0),
        "target_points": np.concatenate(tracks, axis=0),
        "occluded": np.concatenate(occs, axis=0),
    }


def _fix_boundary_visibility(query_points, visibilities, hw):
    """Kubric reports query points on the crop border as invisible; mark them
    visible (reference tapvid.py)."""
    h, w = hw
    vis = visibilities.copy()
    for n in range(query_points.shape[0]):
        t = int(query_points[n, 0])
        if vis[t, n]:
            continue
        x, y = query_points[n, 1:]
        x_b = min(abs(x - 0), abs(x - (w - 1))) < 1e-3
        y_b = min(abs(y - 0), abs(y - (h - 1))) < 1e-3
        x_in = 0 <= x <= w - 1
        y_in = 0 <= y <= h - 1
        if (x_b and y_in) or (x_in and y_b):
            vis[t, n] = True
    return query_points, vis


class TapVidDataset:
    """Per-video pickles packaged as forward-test inputs."""

    def __init__(
        self,
        root: str,
        subset_name: str = "davis",
        query_mode: str = "first",
        input_size=(256, 256),
        eval_size=(256, 256),
    ):
        if query_mode not in QUERY_MODES:
            raise ValueError(f"query_mode must be one of {QUERY_MODES}, got {query_mode!r}")
        self.root = root
        self.subset_name = subset_name
        self.query_mode = query_mode
        self.input_size = tuple(input_size)
        self.eval_size = tuple(eval_size)
        self.samples = sorted(glob.glob(os.path.join(root, "*.pkl")))

    def __len__(self):
        return len(self.samples)

    def load_raw(self, idx: int) -> Dict:
        with open(self.samples[idx], "rb") as f:
            sample = pickle.load(f)
        if isinstance(sample, dict) and len(sample) == 1:
            (sample,) = sample.values()  # {video_name: record}
        if not (isinstance(sample, dict) and "video" in sample):
            raise ValueError(
                f"{self.samples[idx]} looks like an unsplit TAP-Vid release "
                "pickle (many videos in one file); split it into per-video "
                "pickles first (tools/data/split_tapvid.py)"
            )
        return sample

    def _frames(self, video, path: str) -> np.ndarray:
        """(T, H, W, 3) uint8 frames at the input size."""
        if len(video) and isinstance(video[0], bytes):
            video = np.stack([read_image(f) for f in video])
        video = np.asarray(video)
        if video.dtype != np.uint8 or video.ndim != 4:
            raise ValueError(f"{path}: expected (T, H, W, 3) uint8 frames")
        if video.shape[1:3] != self.input_size:
            video = resize_frames(video, self.input_size)
        return video

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self.load_raw(idx)
        video = self._frames(sample["video"], self.samples[idx])
        points = np.asarray(sample["points"], dtype=np.float32).copy()
        occluded = np.asarray(sample["occluded"], dtype=bool)
        points[..., 0] *= self.input_size[1]  # [0, 1] -> input pixels
        points[..., 1] *= self.input_size[0]

        if self.query_mode == "first":
            data = sample_queries_first(occluded, points)
        else:
            data = sample_queries_strided(occluded, points)
        qp = data["query_points"][:, [0, 2, 1]]  # (t, y, x) -> (t, x, y)
        traj = np.transpose(data["target_points"], (1, 0, 2))  # (T, P, 2)
        vis = ~np.transpose(data["occluded"], (1, 0))  # (T, P)
        qp, vis = _fix_boundary_visibility(qp, vis, video.shape[1:3])
        qt = qp[:, 0].astype(np.int64)
        if not np.all(vis[qt, np.arange(vis.shape[1])]):
            raise ValueError(f"{self.samples[idx]}: a query point is not visible")
        return {
            "video": video,
            "query_points": qp.astype(np.float32),
            "trajectories": traj.astype(np.float32),
            "visibilities": vis,
        }

    def evaluate(
        self,
        results: List[Dict[str, np.ndarray]],
        output_dir: Optional[str] = None,
        indices=None,
    ) -> Dict[str, float]:
        """Per-point TAP-Vid summaries on the 256 x 256 raster, averaged per
        video, then over videos.  Each result needs trajectories_gt,
        visibilities_gt, trajectories_pred, visibilities_pred, query_points."""
        sy = self.eval_size[0] / self.input_size[0]
        sx = self.eval_size[1] / self.input_size[1]
        if indices is None:
            indices = range(len(results))
        summaries = []
        for vid, res in zip(indices, results):
            gt = res["trajectories_gt"] * np.array([sx, sy], np.float32)
            pred = res["trajectories_pred"] * np.array([sx, sy], np.float32)
            for n in range(gt.shape[1]):
                summaries.append(
                    compute_point_summary(
                        gt[:, n], pred[:, n],
                        res["visibilities_gt"][:, n],
                        res["visibilities_pred"][:, n],
                        res["query_points"][n],
                        query_mode=self.query_mode,
                        idx=f"{vid}--{n}",
                    )
                )
        agg = aggregate_summaries(summaries)
        if output_dir:
            self._write_reports(summaries, agg, output_dir)
        return agg

    def _write_reports(self, summaries, agg, output_dir):
        """summaries<subset>.json / .csv and a metric table in result.txt
        (the JAX package's per-point figures are not ported)."""
        os.makedirs(output_dir, exist_ok=True)
        base = os.path.join(output_dir, f"summaries{self.subset_name}")
        with open(base + ".json", "w", encoding="utf8") as f:
            json.dump(summaries, f)
        if summaries:
            with open(base + ".csv", "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=sorted(summaries[0]))
                w.writeheader()
                w.writerows(summaries)
        degenerate = ("occlusion_accuracy", "average_jaccard")
        with open(os.path.join(output_dir, "result.txt"), "a") as f:
            f.write(f"\n## TAP-Vid {self.subset_name}\n\n")
            f.write("| metric | value |\n|---|---|\n")
            for k, v in agg.items():
                # visibility is not predicted: occlusion metrics are degenerate
                tag = (" (degenerate: visibility not predicted)"
                       if k in degenerate or k.startswith("jaccard_") else "")
                f.write(f"| {k}{tag} | {v:.4f} |\n")
