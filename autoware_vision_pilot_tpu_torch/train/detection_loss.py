"""Detection training loss, the port of
autoware_vision_pilot_tpu/train/detection_loss.py: task-aligned
assignment, CIoU, DFL and BCE (the reference's Models/training/
auto_speed_util.py: Assigner :482, ComputeLoss :670, BoxLoss + DFL :637,
compute_iou :303).

Shapes stay static, as in the JAX package: the ground-truth boxes come
padded to M with a validity mask, and every data-dependent choice is a
masked reduction, so a step makes no host synchronisation. The gradient
stops are JAX's: the CIoU ``alpha`` and the assigner's inputs are
detached. Ties resolve as in JAX: the assigner's top-k is a stable
descending sort (``lax.top_k`` keeps the lower index first) and argmax
takes the first maximum in both. The loss takes the head's train-mode
output, NHWC maps, as the JAX loss does. Inside a data-parallel step
(parallel/sharding.py::batch_sharded) the normalizer, the target scores'
sum, is the whole batch's.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from ..models.auto_speed import device_anchors
from ..models.yolo_layers import dfl_decode
from ..parallel.sharding import batch_normalizer

GAINS = {"box": 7.5, "cls": 0.5, "dfl": 1.5}


def ciou(box1, box2, eps: float = 1e-7):
    """Complete IoU of aligned box pairs (..., 4) xyxy -> (..., 1)."""
    b1x1, b1y1, b1x2, b1y2 = box1.split(1, -1)
    b2x1, b2y1, b2x2, b2y2 = box2.split(1, -1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp_min(0) * \
            (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp_min(0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def plain_iou_pairs(gt, pd, eps: float = 1e-7):
    """The plain IoU of the assigner's overlap metric, broadcast over (..., 4)."""
    x1 = torch.maximum(gt[..., 0], pd[..., 0])
    y1 = torch.maximum(gt[..., 1], pd[..., 1])
    x2 = torch.minimum(gt[..., 2], pd[..., 2])
    y2 = torch.minimum(gt[..., 3], pd[..., 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    a1 = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1] + eps)
    a2 = (pd[..., 2] - pd[..., 0]) * (pd[..., 3] - pd[..., 1] + eps)
    return inter / (a1 + a2 - inter + eps)


def task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, *,
                        nc: int, top_k: int = 10, alpha: float = 0.5, beta: float = 6.0,
                        eps: float = 1e-9):
    """The static-shape task-aligned assigner (Assigner :482-575).

    pd_scores (B, A, nc) sigmoid; pd_bboxes (B, A, 4) xyxy (stride-scaled);
    anc_points (A, 2); gt_labels (B, M) int; gt_bboxes (B, M, 4) xyxy;
    mask_gt (B, M) bool -> target_bboxes (B, A, 4), target_scores
    (B, A, nc), fg_mask (B, A).
    """
    B, A, _ = pd_scores.shape
    M = gt_bboxes.shape[1]
    # anchor inside gt: (B, M, A)
    lt, rb = gt_bboxes[:, :, None, :2], gt_bboxes[:, :, None, 2:]
    deltas = torch.cat([anc_points[None, None] - lt, rb - anc_points[None, None]], -1)
    mask_in_gts = deltas.amin(-1) > eps
    gt_mask = mask_in_gts & mask_gt[..., None]

    # the alignment metric
    labels = gt_labels.clamp_min(0).long()
    cls_scores = torch.gather(pd_scores.transpose(1, 2), 1, labels[:, :, None].expand(B, M, A))
    bbox_scores = torch.where(gt_mask, cls_scores, 0.0)
    overlaps = torch.where(gt_mask, plain_iou_pairs(gt_bboxes[:, :, None, :], pd_bboxes[:, None]),
                           0.0).clamp_min(0)
    align = bbox_scores ** alpha * overlaps ** beta

    # the top-k anchors of each gt: lax.top_k's order, ties to the lower index
    k = min(top_k, A)
    topv, topi = torch.sort(align, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    valid_k = mask_gt[..., None] & (topv > eps)
    mask_top_k = torch.zeros((B, M, A), dtype=torch.int32, device=align.device)
    mask_top_k.scatter_add_(-1, topi, valid_k.to(torch.int32))
    mask_top_k = torch.where(mask_top_k > 1, 0, mask_top_k)
    mask_pos = mask_top_k.to(align.dtype) * mask_in_gts * mask_gt[..., None]

    # an anchor claimed by several gts keeps the one of largest overlap
    multi = mask_pos.sum(1) > 1                        # (B, A)
    is_max = F.one_hot(overlaps.argmax(1), M).transpose(1, 2).to(align.dtype)
    mask_pos = torch.where(multi[:, None, :], is_max, mask_pos)
    fg_mask = mask_pos.sum(1) > 0                      # (B, A)

    target_gt_idx = mask_pos.argmax(1)                 # (B, A)
    tb = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(B, A, 4))
    tl = torch.gather(labels, 1, target_gt_idx)
    target_scores = F.one_hot(tl, nc).to(align.dtype)
    target_scores = torch.where(fg_mask[..., None], target_scores, 0.0)

    # soft targets: normalized by each gt's best alignment
    align_pos = align * mask_pos
    pos_align = align_pos.amax(-1, keepdim=True)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_pos * pos_overlap / (pos_align + eps)).amax(1)
    return tb, target_scores * norm[..., None], fg_mask


def df_loss(pred_dist, target, reg_max: int):
    """Distribution focal loss: the CE of the two integer bins around the
    continuous target (BoxLoss.df_loss :637), weighted by distance."""
    tl = torch.floor(target).long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, -1)  # (..., 4, reg_max + 1)
    left = -torch.gather(logp, -1, tl[..., None])[..., 0]
    right = -torch.gather(logp, -1, tr.clamp(0, reg_max)[..., None])[..., 0]
    return (left * wl + right * wr).mean(-1)


def detection_loss(outputs: Sequence[torch.Tensor], gt_boxes_xywh, gt_labels, gt_mask, *,
                   nc: int = 4, reg_max: int = 16, strides: Sequence[int] = (8, 16, 32),
                   gains: Dict[str, float] = None,
                   assign: Callable = task_aligned_assign):
    """ComputeLoss (:670-768) with static shapes.

    outputs: the per-level NHWC raw head maps (B, H, W, 4 * reg_max + nc),
    AutoSpeedHead's train-mode output. gt_boxes_xywh (B, M, 4) normalized
    cx, cy, w, h in [0, 1]; gt_labels (B, M) int; gt_mask (B, M) bool.
    ``assign`` is the assigner (a test may hand in another's result).
    -> (total, {"box", "cls", "dfl"}), 0-d tensors.
    """
    gains = gains or GAINS
    B = outputs[0].shape[0]
    no = 4 * reg_max + nc
    flat = torch.cat([o.reshape(B, -1, no) for o in outputs], 1)  # (B, A, no)
    pred_distri, pred_scores = flat[..., :4 * reg_max], flat[..., 4 * reg_max:]
    shapes = tuple((int(o.shape[1]), int(o.shape[2])) for o in outputs)
    anc, strd = device_anchors(shapes, tuple(strides), flat.dtype, flat.device)
    input_h, input_w = outputs[0].shape[1] * strides[0], outputs[0].shape[2] * strides[0]

    # gt xywh (normalized) -> xyxy pixels
    b = gt_boxes_xywh.to(flat.dtype)
    g = torch.stack([b[..., 0] * input_w, b[..., 1] * input_h, b[..., 2] * input_w,
                     b[..., 3] * input_h], -1)
    gt_xyxy = torch.stack([g[..., 0] - g[..., 2] / 2, g[..., 1] - g[..., 3] / 2,
                           g[..., 0] + g[..., 2] / 2, g[..., 1] + g[..., 3] / 2], -1)
    gt_xyxy = torch.where(gt_mask[..., None], gt_xyxy, 0.0)

    # the decoded boxes in anchor units
    d = dfl_decode(pred_distri, reg_max)
    pd_xyxy = torch.cat([anc[None] - d[..., :2], anc[None] + d[..., 2:]], -1)

    tb, ts, fg = assign(torch.sigmoid(pred_scores).detach(), (pd_xyxy * strd[None]).detach(),
                        anc * strd, gt_labels, gt_xyxy, gt_mask, nc=nc)
    ts_sum = batch_normalizer(ts.sum(), 1.0)

    # class BCE
    bce = (pred_scores.clamp_min(0) - pred_scores * ts +
           torch.log1p(torch.exp(-pred_scores.abs())))
    loss_cls = bce.sum() / ts_sum

    # box CIoU and DFL on the foreground anchors (masked)
    tb_anchor = tb / strd[None]
    weight = ts.sum(-1) * fg                              # (B, A)
    iou = ciou(pd_xyxy, tb_anchor)[..., 0]
    loss_box = ((1.0 - iou) * weight).sum() / ts_sum

    lt_t = torch.cat([anc[None] - tb_anchor[..., :2], tb_anchor[..., 2:] - anc[None]], -1)
    lt_t = lt_t.clamp(0, reg_max - 1 - 0.01)
    dist = pred_distri.reshape(B, -1, 4, reg_max)
    dfl = df_loss(dist, lt_t, reg_max - 1)                # (B, A)
    loss_dfl = (dfl * weight).sum() / ts_sum

    total = gains["box"] * loss_box + gains["cls"] * loss_cls + gains["dfl"] * loss_dfl
    return total, {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl}
