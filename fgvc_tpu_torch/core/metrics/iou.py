"""Segmentation IoU and Dice over label maps (a copy of
fgvc_tpu/core/metrics/iou.py, numpy on the host like core/metrics/vos.py):
per-class intersection and union histograms, pooled over the maps.

  * ``intersect_and_union``: one prediction against its label map, the
    pixels whose label is ``ignore_index`` left out; values outside
    [0, num_classes) fall in no bin.
  * ``mean_iou``: per-class IoU and accuracy (intersection over the label's
    area) over all maps, each over max(denominator, 1e-12), so a class
    absent from labels and predictions scores 0; ``nan_to_num`` replaces
    NaNs; mIoU is the mean over classes.
  * ``mean_dice``: per-class Dice, 2 intersection / (prediction + label
    area), and its mean.

    m = mean_iou(preds, labels, num_classes=3)   # {"IoU", "Acc", "mIoU"}
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def intersect_and_union(pred: np.ndarray, label: np.ndarray, num_classes: int,
                        ignore_index: int = 255):
    """Per-class (intersection, union, prediction area, label area)."""
    mask = label != ignore_index
    pred = pred[mask]
    label = label[mask]
    inter = pred[pred == label]
    area_i = np.histogram(inter, bins=num_classes, range=(0, num_classes))[0]
    area_p = np.histogram(pred, bins=num_classes, range=(0, num_classes))[0]
    area_l = np.histogram(label, bins=num_classes, range=(0, num_classes))[0]
    return area_i, area_p + area_l - area_i, area_p, area_l


def mean_iou(preds: Sequence[np.ndarray], labels: Sequence[np.ndarray], num_classes: int,
             ignore_index: int = 255, nan_to_num=None) -> Dict[str, np.ndarray]:
    """{"IoU": (num_classes,), "Acc": (num_classes,), "mIoU": float}."""
    ti = np.zeros(num_classes)
    tu = np.zeros(num_classes)
    tl = np.zeros(num_classes)
    for p, l in zip(preds, labels):
        i, u, _, a_l = intersect_and_union(p, l, num_classes, ignore_index)
        ti += i
        tu += u
        tl += a_l
    iou = ti / np.maximum(tu, 1e-12)
    acc = ti / np.maximum(tl, 1e-12)
    if nan_to_num is not None:
        iou = np.nan_to_num(iou, nan=nan_to_num)
        acc = np.nan_to_num(acc, nan=nan_to_num)
    return {"IoU": iou, "Acc": acc, "mIoU": float(iou.mean())}


def mean_dice(preds: Sequence[np.ndarray], labels: Sequence[np.ndarray], num_classes: int,
              ignore_index: int = 255) -> Dict[str, np.ndarray]:
    """{"Dice": (num_classes,), "mDice": float}."""
    ti = np.zeros(num_classes)
    tp = np.zeros(num_classes)
    tl = np.zeros(num_classes)
    for p, l in zip(preds, labels):
        i, _, a_p, a_l = intersect_and_union(p, l, num_classes, ignore_index)
        ti += i
        tp += a_p
        tl += a_l
    dice = 2 * ti / np.maximum(tp + tl, 1e-12)
    return {"Dice": dice, "mDice": float(dice.mean())}
