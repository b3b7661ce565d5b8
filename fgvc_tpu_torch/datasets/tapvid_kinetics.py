"""TAP-Vid-Kinetics from the released annotation CSV and the video clips
(fgvc_tpu/datasets/tapvid_kinetics.py): the CSV join the pickle generator
uses, and `TapVidKineticsVideoDataset`, which decodes each clip when it is
read (datasets/video_decode.py, the port's own video reader), so the
pickle step is optional:

    python -m fgvc_tpu_torch.cli.test --task kinetics --data-root <clips> \\
        --annotations tapvid_kinetics.csv

Clips in VP8 and VP9 (.webm/.mkv; VP9 profile 0, YouTube's usual
Kinetics download), MPEG-4 Part 2 (.mp4, what cv2's 'mp4v' writes) and
Motion-JPEG (.mp4 and .mkv, what cv2's 'MJPG' writes) decode; a clip in a
codec the port does not decode raises ValueError with the clip's path and
codec; it is never skipped.  The clips are looked up under VIDEO_EXTS, as
the JAX reader looks them up (an .avi is never opened here).
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

VIDEO_EXTS = (".mp4", ".mkv", ".webm")


def read_annotations(csv_path: str) -> Dict:
    """CSV rows: video_id, point_id, frame, x, y, occluded (x/y in [0,1]).

    Returns {video_id: {point_id: {frame: (x, y, occ)}}}."""
    per_video: Dict = defaultdict(lambda: defaultdict(dict))
    with open(csv_path) as f:
        for row in csv.reader(f):
            if not row or row[0] == "video_id":
                continue
            vid, pid, frame = row[0], int(row[1]), int(row[2])
            x, y, occ = float(row[3]), float(row[4]), int(float(row[5]))
            per_video[vid][pid][frame] = (x, y, occ)
    return per_video


def assemble_tracks(points: Dict, T: int) -> Tuple[np.ndarray, np.ndarray]:
    """One video's CSV records -> ((N, T, 2) points in [0,1], (N, T)
    occluded).  Frames without a row stay occluded at (0, 0), as the pickle
    generator writes them."""
    pids = sorted(points)
    pts = np.zeros((len(pids), T, 2), np.float32)
    occ = np.ones((len(pids), T), bool)
    for i, pid in enumerate(pids):
        for t, (x, y, o) in points[pid].items():
            if t < T:
                pts[i, t] = (x, y)
                occ[i, t] = bool(o)
    return pts, occ


def find_clip(video_root: str, video_id: str):
    for ext in VIDEO_EXTS:
        cand = os.path.join(video_root, video_id + ext)
        if os.path.exists(cand):
            return cand
    return None


class TapVidKineticsVideoDataset(TapVidDataset):
    """TAP-Vid-Kinetics evaluated straight from CSV and clips (no pickles).

    The protocol is TapVidDataset(subset_name='kinetics')'s: its __getitem__
    and evaluate run unchanged; only sample discovery and `load_raw` differ
    (a clip decode in place of a pickle read)."""

    def __init__(self, video_root: str, annotations: str, query_mode: str = "first",
                 input_size=(256, 256), eval_size=(256, 256)):
        super().__init__(video_root, subset_name="kinetics", query_mode=query_mode,
                         input_size=input_size, eval_size=eval_size)
        per_video = read_annotations(annotations)
        self.samples = []  # (video_id, clip_path, per-point records)
        missing = 0
        for vid in sorted(per_video):
            path = find_clip(video_root, vid)
            if path is None:
                missing += 1
                continue
            self.samples.append((vid, path, per_video[vid]))
        if not self.samples:
            raise ValueError(f"no annotated clips found under {video_root!r} "
                             f"({missing} CSV video ids have no clip file)")
        self.missing_clips = missing

    def load_raw(self, idx: int) -> Dict:
        from fgvc_tpu_torch.datasets.video_decode import decode_video

        _, path, points = self.samples[idx]
        # a per-frame resize keeps T x input_size in memory, not T x native;
        # T is the decodable count (CSV rows past it drop, as in the pickles)
        video = decode_video(path, resize=(self.input_size[1], self.input_size[0]))
        pts, occ = assemble_tracks(points, video.shape[0])
        return {"video": video, "points": pts, "occluded": occ}
