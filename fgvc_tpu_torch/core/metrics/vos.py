"""DAVIS VOS metrics: region similarity J (IoU) and boundary F-measure
(a copy of fgvc_tpu/core/metrics/vos.py).

The standard DAVIS-2017 definitions:

  * J = per-frame IoU between binary masks (union≈0 → 1),
  * F = boundary precision/recall with disk-dilated boundary matching,
    bound_th 0.008 × image diagonal,
  * statistics per object: M(ean), R(ecall: fraction of frames > 0.5),
    D(ecay: first-quartile mean minus last-quartile mean).

The boundary dilation (cv2.dilate with a disk in the original) is
`dilate_disk`: the disk split into horizontal runs, each a running max
(scipy.ndimage.maximum_filter1d), which gives the same masks without cv2.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Sequence

import numpy as np


def eval_iou(annotation: np.ndarray, segmentation: np.ndarray) -> np.ndarray:
    """Jaccard index; inputs binary (..., H, W)."""
    annotation = annotation.astype(bool)
    segmentation = segmentation.astype(bool)
    inters = np.sum(segmentation & annotation, axis=(-2, -1))
    union = np.sum(segmentation | annotation, axis=(-2, -1))
    j = inters / np.maximum(union, 1e-12)
    j = np.where(np.isclose(union, 0), 1.0, j)
    return j


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Binary boundary map: pixels whose east/south/south-east neighbor
    differs (the DAVIS seg2bmap definition for matching output size)."""
    seg = seg.astype(bool)
    h, w = seg.shape
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = 0
    return b


def dilate_disk(mask: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation of an (H, W) mask by the disk x^2 + y^2 <= r^2
    (skimage.morphology.disk), zero outside the image: cv2.dilate's result
    for that element.  The disk is split into its rows: row dy is a
    horizontal run of half-width isqrt(r^2 - dy^2), a 1-D running max."""
    from scipy.ndimage import maximum_filter1d

    m = mask.astype(np.uint8)
    H = m.shape[0]
    r = int(radius)
    out = np.zeros_like(m)
    runs: Dict[int, np.ndarray] = {}
    for dy in range(-r, r + 1):
        hw = math.isqrt(r * r - dy * dy)
        if hw not in runs:
            runs[hw] = maximum_filter1d(m, 2 * hw + 1, axis=1, mode="constant", cval=0)
        run = runs[hw]
        if dy >= 0:
            np.maximum(out[: H - dy], run[dy:], out=out[: H - dy])
        else:
            np.maximum(out[-dy:], run[: H + dy], out=out[-dy:])
    return out


def f_measure(
    foreground_mask: np.ndarray, gt_mask: np.ndarray, bound_th: float = 0.008
) -> float:
    """Boundary F-measure between two binary masks."""
    bound_pix = (
        bound_th
        if bound_th >= 1
        else np.ceil(bound_th * np.linalg.norm(foreground_mask.shape))
    )
    fg_b = _seg2bmap(foreground_mask)
    gt_b = _seg2bmap(gt_mask)
    fg_dil = dilate_disk(fg_b, bound_pix)
    gt_dil = dilate_disk(gt_b, bound_pix)

    gt_match = gt_b * fg_dil
    fg_match = fg_b * gt_dil
    n_fg = fg_b.sum()
    n_gt = gt_b.sum()

    if n_fg == 0 and n_gt > 0:
        return 0.0
    if n_fg > 0 and n_gt == 0:
        return 0.0
    if n_fg == 0 and n_gt == 0:
        return 1.0
    precision = fg_match.sum() / float(n_fg)
    recall = gt_match.sum() / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def eval_boundary(
    annotation: np.ndarray, segmentation: np.ndarray, bound_th: float = 0.008
) -> np.ndarray:
    """Per-frame boundary F for (T, H, W) or single (H, W) binary masks."""
    if annotation.ndim == 2:
        return np.asarray(f_measure(segmentation, annotation, bound_th))
    return np.array(
        [
            f_measure(segmentation[t], annotation[t], bound_th)
            for t in range(annotation.shape[0])
        ]
    )


def statistics(per_frame_values: np.ndarray):
    """(Mean, Recall, Decay) over a per-frame metric array."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        m = np.nanmean(per_frame_values)
        o = np.nanmean(per_frame_values > 0.5)
        n_bins = 4
        ids = (
            np.round(
                np.linspace(1, len(per_frame_values), n_bins + 1) + 1e-10
            )
            - 1
        ).astype(int)
        bins = [
            per_frame_values[ids[i] : ids[i + 1] + 1] for i in range(n_bins)
        ]
        d = np.nanmean(bins[0]) - np.nanmean(bins[3])
    return float(m), float(o), float(d)


def evaluate_video_jf(
    gt_masks: np.ndarray,    # (T, H, W) integer labels, 0 = background
    res_masks: np.ndarray,   # (T, H, W) integer labels
    num_objects: int,
) -> Dict[str, List[float]]:
    """Per-object J&F statistics for one video (first/last frame included;
    trimming to the DAVIS [1:-1] protocol is the caller's choice)."""
    out: Dict[str, List[float]] = {k: [] for k in ("JM", "JR", "JD", "FM", "FR", "FD")}
    for obj in range(1, num_objects + 1):
        gt = gt_masks == obj
        res = res_masks == obj
        j = eval_iou(gt, res)
        f = eval_boundary(gt, res)
        jm, jr, jd = statistics(j)
        fm, fr, fd = statistics(f)
        out["JM"].append(jm)
        out["JR"].append(jr)
        out["JD"].append(jd)
        out["FM"].append(fm)
        out["FR"].append(fr)
        out["FD"].append(fd)
    return out


def aggregate_jf(per_video: Sequence[Dict[str, List[float]]]) -> Dict[str, float]:
    """Global means + J&F-mean over all objects of all videos."""
    pooled: Dict[str, List[float]] = {}
    for vid in per_video:
        for k, vals in vid.items():
            pooled.setdefault(k, []).extend(vals)
    out = {k: float(np.mean(v)) for k, v in pooled.items() if v}
    if "JM" in out and "FM" in out:
        out["J&F-Mean"] = (out["JM"] + out["FM"]) / 2.0
    return out
