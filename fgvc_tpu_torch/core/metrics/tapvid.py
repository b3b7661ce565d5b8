"""TAP-Vid point-tracking metrics (<D, AJ, OA) — pure numpy.

The port's own copy of fgvc_tpu/core/metrics/tapvid.py (the port imports
nothing of fgvc_tpu); the tests hold the two to the same numbers.

Implements the metric definitions of the TAP-Vid benchmark exactly as used by
the reference evaluation (compute_tapvid_metrics in the reference's
mmpt/datasets/tapvid_evaluation_datasets.py, itself the published DeepMind
tapnet evaluation), re-written from the definitions:

  * evaluation points exclude the query frame itself, and — in 'first' query
    mode — every frame before the first visible frame of the track,
  * pts_within_x: fraction of gt-visible evaluation points whose prediction
    lies within x pixels (prediction visibility ignored),
  * jaccard_x: TP / (gt_visible + FP) where TP requires pred-visible and
    within x; FP = pred-visible but gt-occluded-or-too-far,
  * occlusion_accuracy: agreement of predicted and gt occlusion flags,
  * <D ("average_pts_within_thresh") and AJ average thresholds [1,2,4,8,16].

All coordinates are expected in the 256×256 TAP-Vid raster scale.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np

THRESHOLDS = (1, 2, 4, 8, 16)


def compute_tapvid_metrics(
    query_points: np.ndarray,
    gt_occluded: np.ndarray,
    gt_tracks: np.ndarray,
    pred_occluded: np.ndarray,
    pred_tracks: np.ndarray,
    query_mode: str,
    additional_pck_thresholds: Iterable[float] = (),
) -> Dict[str, np.ndarray]:
    """Compute TAP-Vid metrics for a batch of videos.

    Args:
      query_points: (B, N, 3) — only [..., 0] (query frame t) is used.
      gt_occluded / pred_occluded: (B, N, T) boolean, True = occluded.
      gt_tracks / pred_tracks: (B, N, T, 2) (x, y).
      query_mode: 'first' or 'strided'.

    Returns: dict of per-video arrays (fractions in [0, 1]).
    """
    if query_mode not in ("first", "strided"):
        raise ValueError(f"unknown query mode {query_mode}")

    B, N, T = gt_occluded.shape
    metrics: Dict[str, np.ndarray] = {}

    q_frame = np.round(query_points[..., 0]).astype(np.int32)  # (B, N)
    frames = np.arange(T)[None, None]
    eval_pts = frames != q_frame[..., None]  # (B, N, T)

    if query_mode == "first":
        # PUBLISHED QUIRK reproduced exactly: np.where over the 2-D (N, T)
        # occlusion array, so the index is the first TRACK with any visible
        # frame and the first `index` tracks are masked entirely
        # (tapvid_evaluation_datasets.py:173-177). For the reference's
        # per-point calling convention (N == 1) this masks nothing when the
        # track is ever visible. Guard the all-occluded case (the published
        # code would IndexError) by masking nothing.
        for b in range(B):
            vis_rows = np.where(gt_occluded[b] == 0)[0]
            if len(vis_rows):
                eval_pts[b, : vis_rows[0]] = False

    occ_correct = np.equal(pred_occluded, gt_occluded) & eval_pts
    # PUBLISHED QUIRK: denominator is the FULL batch sum, not per-video —
    # correct only for B == 1, the reference's (and our) calling convention.
    metrics["occlusion_accuracy"] = occ_correct.sum(axis=(1, 2)) / eval_pts.sum()

    visible = ~gt_occluded
    pred_visible = ~pred_occluded
    all_frac, all_jac = [], []
    sq_dist = np.sum(np.square(pred_tracks - gt_tracks), axis=-1)  # (B, N, T)
    # zero denominators yield NaN like the published code — downstream
    # aggregation skips NaN (pandas .mean semantics), so degenerate points
    # (visible only at the query frame) are dropped, not scored as 0
    with np.errstate(invalid="ignore", divide="ignore"):
        for thr in THRESHOLDS:
            within = sq_dist < thr * thr
            correct = within & visible
            frac = (correct & eval_pts).sum(axis=(1, 2)) / (
                visible & eval_pts
            ).sum(axis=(1, 2))
            metrics[f"pts_within_{thr}"] = frac
            all_frac.append(frac)

            tp = (correct & pred_visible & eval_pts).sum(axis=(1, 2))
            gt_pos = (visible & eval_pts).sum(axis=(1, 2))
            fp = (((~visible) & pred_visible) | ((~within) & pred_visible))
            fp = (fp & eval_pts).sum(axis=(1, 2))
            jac = tp / (gt_pos + fp)
            metrics[f"jaccard_{thr}"] = jac
            all_jac.append(jac)

        for thr in additional_pck_thresholds:
            within = sq_dist < thr * thr
            frac = (within & visible & eval_pts).sum(axis=(1, 2)) / (
                visible & eval_pts
            ).sum(axis=(1, 2))
            metrics[f"pts_within_{thr}"] = frac

    metrics["average_jaccard"] = np.mean(np.stack(all_jac, axis=1), axis=1)
    metrics["average_pts_within_thresh"] = np.mean(np.stack(all_frac, axis=1), axis=1)
    return metrics


# the reference's extra PCK threshold list (figures.py:286-291)
ADDITIONAL_PCK_THRESHOLDS = (
    0.01,
    0.05,
    *[0.1 * (i + 1) for i in range(10)],
    *[float(i + 1) for i in range(10)],
)


def compute_point_summary(
    trajectory_gt: np.ndarray,     # (T, 2)
    trajectory_pred: np.ndarray,   # (T, 2)
    visibility_gt: np.ndarray,     # (T,)
    visibility_pred: np.ndarray,   # (T,)
    query_point: np.ndarray,       # (3,) (t, x, y)
    query_mode: str = "first",
    idx: str = "",
) -> Dict[str, float]:
    """Per-point metric summary (×100), the reference's compute_summary unit
    (the reference's mmpt/datasets/flyingthingsplus/utils/figures.py).

    The benchmark score is the mean of these per-point summaries over every
    point of every video.
    """
    vis = visibility_gt.astype(bool)
    d = np.linalg.norm(trajectory_pred - trajectory_gt, axis=-1)
    summary: Dict[str, float] = {
        "idx": idx,
        "ade": float(d.mean()) if len(d) else float("nan"),
        "ade_visible": float(d[vis].mean()) if vis.any() else float("nan"),
        "n_timesteps": int(len(trajectory_gt)),
        "n_timesteps_visible": int(vis.sum()),
    }
    m = compute_tapvid_metrics(
        query_points=query_point[None, None, :],
        gt_occluded=~visibility_gt[None, None, :].astype(bool),
        gt_tracks=trajectory_gt[None, None],
        pred_occluded=~visibility_pred[None, None, :].astype(bool),
        pred_tracks=trajectory_pred[None, None],
        query_mode=query_mode,
        additional_pck_thresholds=ADDITIONAL_PCK_THRESHOLDS,
    )
    summary.update({k: float(v.item()) * 100.0 for k, v in m.items()})
    return summary


def aggregate_summaries(summaries) -> Dict[str, float]:
    """Benchmark-table aggregation matching the reference's table3
    (figures.py:617-640): per-point summaries are averaged PER VIDEO first
    (pandas groupby 'iter' = idx.split('--')[0], NaN-skipping), then over
    videos — videos with different point counts weigh equally."""
    keys = [
        "average_jaccard",
        "average_pts_within_thresh",
        "occlusion_accuracy",
        *[f"pts_within_{t}" for t in THRESHOLDS],
        *[f"pts_within_{t}" for t in ADDITIONAL_PCK_THRESHOLDS],
        *[f"jaccard_{t}" for t in THRESHOLDS],
        "ade",
        "ade_visible",
    ]
    groups: Dict[str, list] = {}
    for s in summaries:
        vid = str(s.get("idx", "")).split("--")[0]
        groups.setdefault(vid, []).append(s)
    out = {}
    for k in keys:
        per_video = []
        for vid_summaries in groups.values():
            vals = [
                s[k] for s in vid_summaries if k in s and np.isfinite(s[k])
            ]
            if vals:
                per_video.append(float(np.mean(vals)))
        out[k] = float(np.mean(per_video)) if per_video else float("nan")
    return out
