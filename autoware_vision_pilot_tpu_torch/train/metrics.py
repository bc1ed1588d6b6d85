"""Evaluation metrics, the port of autoware_vision_pilot_tpu/train/
metrics.py, in numpy on the host: the confusion matrix and mIoU (the
reference's validation, scene_seg_trainer.py calc_IoU_val), COCO-style
detection mAP (auto_speed_util.py:225, 101-point interpolation over IoU
thresholds .5:.95) and the AutoSteer 2.0 lane-vector AP.
"""
from __future__ import annotations

import numpy as np

# np.trapz was renamed np.trapezoid in NumPy 2.0
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


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


def box_iou_matrix(a, b):
    """IoU between two sets of xyxy boxes: (N,4) x (M,4) -> (N,M)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def average_precision(recalls, precisions):
    """COCO 101-point interpolated AP: mean over recall grid of the
    precision envelope max{p_i : r_i >= r}."""
    r = np.asarray(recalls)
    if r.size == 0:
        # a class with ground truth but no predictions at all: AP = 0
        return 0.0
    p = np.maximum.accumulate(np.asarray(precisions)[::-1])[::-1]
    grid = np.linspace(0, 1, 101)
    # index of first recall >= grid point
    idx = np.searchsorted(r, grid, side="left")
    vals = np.where(idx < len(p), p[np.minimum(idx, len(p) - 1)], 0.0)
    return float(vals.mean())


def detection_map(predictions, ground_truths, num_classes: int,
                  iou_thresholds=None):
    """COCO-style mAP.

    predictions: list per image of (boxes (N,4), scores (N,), cls (N,)).
    ground_truths: list per image of (boxes (M,4), cls (M,)).
    Returns (mAP@.5, mAP@[.5:.95]).
    """
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    aps = np.zeros((len(iou_thresholds), num_classes))
    counts = np.zeros(num_classes)

    for c in range(num_classes):
        # flatten all predictions of class c with image ids
        recs = []
        n_gt = 0
        gt_by_img = []
        for img_i, (gb, gc) in enumerate(ground_truths):
            sel = np.asarray(gc) == c
            gt_by_img.append(np.asarray(gb)[sel])
            n_gt += int(sel.sum())
        for img_i, (pb, ps, pc) in enumerate(predictions):
            sel = np.asarray(pc) == c
            for b, s in zip(np.asarray(pb)[sel], np.asarray(ps)[sel]):
                recs.append((float(s), img_i, b))
        if n_gt == 0:
            aps[:, c] = np.nan
            continue
        counts[c] = 1
        recs.sort(key=lambda r: -r[0])

        for ti, t in enumerate(iou_thresholds):
            matched = [np.zeros(len(g), bool) for g in gt_by_img]
            tp = np.zeros(len(recs))
            fp = np.zeros(len(recs))
            for ri, (s, img_i, box) in enumerate(recs):
                gts = gt_by_img[img_i]
                if len(gts) == 0:
                    fp[ri] = 1
                    continue
                ious = box_iou_matrix(box[None], gts)[0]
                best = int(np.argmax(ious))
                if ious[best] >= t and not matched[img_i][best]:
                    matched[img_i][best] = True
                    tp[ri] = 1
                else:
                    fp[ri] = 1
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            rec = ctp / n_gt
            prec = ctp / np.maximum(ctp + cfp, 1e-12)
            aps[ti, c] = average_precision(rec, prec)

    map50 = float(np.nanmean(aps[0]))
    map_full = float(np.nanmean(aps))
    return map50, map_full


def vector_ap(tp_by_thresh: dict, fp_by_thresh: dict, conf, n_targets: int,
              eps: float = 1e-16):
    """AutoSteer 2.0 lane-vector AP (auto_steer_util.py:352-399,
    compute_vector_ap): per distance threshold, sort the per-line TP/FP
    decisions by confidence, 101-point interpolated AP; mAP@50 is the AP
    at the 0.05 normalized-distance threshold, mean AP averages all
    thresholds; precision/recall are means over thresholds of the running
    precision/recall means.

    Returns (m_precision, m_recall, mean_ap, map50).
    """
    thresholds = sorted(tp_by_thresh.keys())
    conf = np.asarray(conf, np.float64)
    order = np.argsort(-conf)
    ap_by_t = {}
    precisions, recalls = [], []
    for t in thresholds:
        tp = np.asarray(tp_by_thresh[t], np.float64)[order]
        fp = np.asarray(fp_by_thresh[t], np.float64)[order]
        tpc, fpc = tp.cumsum(), fp.cumsum()
        precision = tpc / (tpc + fpc + eps)
        recall = tpc / (n_targets + eps)
        m_rec = np.concatenate(([0.0], recall, [1.0]))
        m_pre = np.concatenate(([0.0], precision, [0.0]))
        m_pre = np.flip(np.maximum.accumulate(np.flip(m_pre)))
        x = np.linspace(0, 1, 101)
        ap_by_t[t] = float(_trapezoid(np.interp(x, m_rec, m_pre), x))
        precisions.append(float(precision.mean()))
        recalls.append(float(recall.mean()))
    map50 = ap_by_t.get(0.05, ap_by_t[thresholds[0]])
    mean_ap = float(np.mean(list(ap_by_t.values())))
    return float(np.mean(precisions)), float(np.mean(recalls)), mean_ap, map50
