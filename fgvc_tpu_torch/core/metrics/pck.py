"""PCK keypoint metrics of JHMDB and BADJA (fgvc_tpu/core/metrics/pck.py).

* JHMDB: per keypoint track, the distance between prediction and ground
  truth is normalised by 0.6 x the diagonal of the box of the ground-truth
  joints predicted visible in that frame (predicted x > 0); PCK@alpha is
  the percentage of normalised distances <= alpha, averaged over the 15
  keypoints.
* BADJA: threshold alpha x sqrt(segmentation mask area) per frame; PCK@alpha
  is the percentage of visible joints within it, pooled over every (frame,
  joint) of every video.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

JHMDB_NUM_KEYPOINTS = 15


def jhmdb_pck(
    pred_poses_list: Sequence[np.ndarray],   # each (2, 15, T) (x; y)
    gt_poses_list: Sequence[np.ndarray],     # each (2, 15, T)
    alphas: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
) -> Dict[str, float]:
    """JHMDB PCK with the 0.6 x box-diagonal normalisation."""
    nk = JHMDB_NUM_KEYPOINTS
    dist_all: List[List[float]] = [[] for _ in range(nk)]
    for pred, gt in zip(pred_poses_list, gt_poses_list):
        clip_len = min(pred.shape[-1], gt.shape[-1])
        pred = pred[..., :clip_len]
        gt = gt[..., :clip_len]
        vis = pred[0] > 0  # (15, T): a joint is visible where its predicted x > 0
        gmax = gt.copy()
        gmax[:, ~vis] = -1
        gmin = gt.copy()
        gmin[:, ~vis] = 1e6
        boxes = np.stack([gmax[0].max(axis=0) - gmin[0].min(axis=0),
                          gmax[1].max(axis=0) - gmin[1].min(axis=0)], axis=0)
        boxes = 0.6 * np.linalg.norm(boxes, axis=0)  # (T,)
        for t in range(clip_len):
            for k in range(nk):
                if vis[k, t]:
                    d = np.linalg.norm(pred[:, k, t] - gt[:, k, t])
                    dist_all[k].append(d / boxes[t])
    out = {}
    for alpha in alphas:
        per_kp = [100.0 * np.mean(np.asarray(d) <= alpha) if len(d) else 0.0 for d in dist_all]
        out[f"PCK@{alpha}"] = float(np.mean(per_kp))
    return out


def badja_pck(
    per_frame: Sequence[Dict],
    alphas: Sequence[float] = (0.1, 0.2, 0.3, 0.4),
) -> Dict[str, float]:
    """BADJA PCK pooled over (frame, joint) pairs.  Each entry: {'pred':
    (P, 2) xy, 'gt': (P, 2) xy at the prediction's resolution, 'visible':
    (P,), 'mask_area': float}."""
    correct: Dict[float, List[bool]] = {a: [] for a in alphas}
    for fr in per_frame:
        thr_base = np.sqrt(float(fr["mask_area"]))
        d = np.linalg.norm(fr["pred"] - fr["gt"], axis=-1)  # (P,)
        for a in alphas:
            thr = a * thr_base
            correct[a] += [bool(d[j] < thr) for j in range(len(d)) if fr["visible"][j] > 0]
    return {f"PCK@{a}": float(100.0 * np.mean(correct[a])) if correct[a] else 0.0
            for a in alphas}
