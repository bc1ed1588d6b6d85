"""Segmentation metrics, the port of
autoware_vision_pilot_tpu/train/metrics.py::confusion_matrix and
::miou_from_confusion, in numpy (export/eval_lite.py scores on the host).

Only what export/eval_lite.py needs is ported. The detection mAP
(``box_iou_matrix``, ``average_precision``, ...) waits for ROADMAP Queue 1
item 6 (training).
"""
from __future__ import annotations

import numpy as np


def confusion_matrix(pred_ids, gt_ids, num_classes: int,
                     ignore_index: int | None = None) -> np.ndarray:
    """(num_classes, num_classes) counts, rows ground truth, columns
    prediction, of int arrays of one shape (numpy, or CPU tensors). Pixels
    whose ground truth is ``ignore_index`` are not counted, and neither is
    a pair that falls outside the matrix (the JAX scatter drops it)."""
    p = np.asarray(pred_ids).reshape(-1).astype(np.int64)
    g = np.asarray(gt_ids).reshape(-1).astype(np.int64)
    if ignore_index is not None:
        keep = g != ignore_index
        p, g = p[keep], g[keep]
    idx = g * num_classes + p
    idx = idx[(idx >= 0) & (idx < num_classes * num_classes)]
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def miou_from_confusion(cm):
    """-> (per-class IoU, NaN for a class that never occurs or is
    predicted; their nan-mean; overall pixel accuracy)."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    denom = tp + fp + fn
    iou = np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)
    miou = float(np.nanmean(iou))
    overall = float(tp.sum() / max(cm.sum(), 1))
    return iou, miou, overall
