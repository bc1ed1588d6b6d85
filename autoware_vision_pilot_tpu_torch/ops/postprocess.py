"""Per-frame post-processing, the port of
autoware_vision_pilot_tpu/ops/postprocess.py: the mask ops, the colour
overlay, and the longitudinal program's YOLO decode and fixed-shape greedy
NMS. NHWC in, JAX layouts out."""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from .device import constant_on


def argmax_mask(logits_nhwc):
    """(B,H,W,C) logits -> (B,H,W) int32 class ids; ties take the first
    index, as jnp.argmax does."""
    return torch.argmax(logits_nhwc, dim=-1).to(torch.int32)


def colorize_mask(mask, palette):
    """(B,H,W) ids + (C,3) uint8 palette -> (B,H,W,3) uint8 colour image."""
    palette = torch.as_tensor(palette, dtype=torch.uint8, device=mask.device)
    return palette[mask.long()]


def blend_overlay(image_u8, color_u8, alpha: float = 0.5):
    """The 50/50 overlay of masks_visualization_engine.cpp:28-30, as the JAX
    package computes it: image * (1 - alpha) + color * alpha in f32, each
    product and the sum rounded on its own (no FMA), then truncated toward
    zero to uint8."""
    out = image_u8.to(torch.float32) * (1 - alpha) + color_u8.to(torch.float32) * alpha
    return out.to(torch.uint8)


def threshold_channels(logits_nhwc, threshold: float = 0.0):
    """EgoLanes per-channel binary masks (value > thr -> 1.0)."""
    return (logits_nhwc > threshold).to(torch.float32)


def depth_minmax_scale(depth_nhw1):
    """Scale relative depth to [0,1] per frame."""
    lo = depth_nhw1.amin(dim=(-3, -2, -1), keepdim=True)
    hi = depth_nhw1.amax(dim=(-3, -2, -1), keepdim=True)
    return (depth_nhw1 - lo) / (hi - lo).clamp_min(1e-9)


def nms_topk(boxes_xyxy, scores, class_ids, *, max_det: int = 64,
             conf_thresh: float = 0.25):
    """The first steps of the JAX package's ``nms_fixed``: scores below
    ``conf_thresh`` become -1, and the k = min(4 * max_det, A) highest are
    kept in descending order, equal scores by lower index (as
    ``lax.top_k``). (..., A, 4), (..., A), (..., A) -> top boxes (..., k,
    4), scores (..., k), classes (..., k): a stream of a batch each."""
    k = min(max_det * 4, scores.shape[-1])
    scores = torch.where(scores >= conf_thresh, scores, -1.0)
    top_scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    top = order[..., :k]
    boxes = boxes_xyxy.gather(-2, top[..., None].expand(*top.shape, 4))
    return boxes, top_scores[..., :k].contiguous(), class_ids.gather(-1, top)


def nms_greedy_plain(top_boxes, top_scores, top_cls, *, max_det: int = 64,
                     iou_thresh: float = 0.45, conf_thresh: float = 0.25,
                     class_aware: bool = True):
    """The rest of ``nms_fixed`` on ``nms_topk``'s candidates, eagerly, in
    the JAX package's operations: the k x k IoU > thresh (same-class)
    matrix, k greedy steps, and the kept boxes compacted in score order.
    The plain version of the NMS kernel (ops/kernels/nms_kernel.py).
    (..., k, 4), (..., k), (..., k), a stream of a batch each, every stream
    on its own -> boxes (..., max_det, 4), scores (..., max_det), classes
    (..., max_det), valid (..., max_det) bool; zeros where not valid."""
    x1, y1, x2, y2 = top_boxes.unbind(-1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    union = area[..., :, None] + area[..., None, :] - inter
    iou = torch.where(union > 0, inter / union, 0.0)
    suppress = iou > iou_thresh  # row suppresses column
    if class_aware:
        suppress &= top_cls[..., :, None] == top_cls[..., None, :]

    alive = top_scores >= conf_thresh
    for i in range(top_scores.shape[-1]):
        kill = suppress[..., i, :] & alive[..., i, None]
        kill[..., i] = False
        alive = alive & ~kill

    # compact the kept candidates to the front, in score order; the rest
    # go to a dropped row max_det
    rank = torch.cumsum(alive, -1) - 1
    dst = torch.where(alive & (rank < max_det), rank, max_det)
    lead = alive.shape[:-1]
    at = [torch.arange(n, device=alive.device).view(-1, *[1] * (len(lead) - i))
          for i, n in enumerate(lead)]

    def compact(values):
        out = values.new_zeros((*lead, max_det + 1, *values.shape[len(lead) + 1:]))
        return out.index_put_((*at, dst), values).narrow(len(lead), 0, max_det)

    return compact(top_boxes), compact(top_scores), compact(top_cls), compact(alive)


def decode_yolo_to_original(pred_a4nc, scale: float, pad_xy: Tuple[int, int],
                            orig_hw: Tuple[int, int]):
    """(..., A, 4 + nc) decoded head output (xywh in letterbox pixels,
    class scores) -> (boxes_xyxy (..., A, 4) in original-image pixels,
    clamped; best score (..., A); best class (..., A) int32, the first
    maximum, as jnp.argmax).

    ``scale`` divides as an f32 tensor on the device of ``pred_a4nc``, not
    as a Python number: PyTorch's CUDA division by a CPU scalar multiplies
    by its reciprocal, which is not the f32 division the CPU makes."""
    cx, cy, w, h = pred_a4nc[..., :4].unbind(-1)
    s = _scalar(scale, pred_a4nc.device)
    x1 = (cx - w / 2 - pad_xy[0]) / s
    y1 = (cy - h / 2 - pad_xy[1]) / s
    x2 = (cx + w / 2 - pad_xy[0]) / s
    y2 = (cy + h / 2 - pad_xy[1]) / s
    oh, ow = orig_hw
    boxes = torch.stack([x1.clamp(0, ow), y1.clamp(0, oh),
                         x2.clamp(0, ow), y2.clamp(0, oh)], -1)
    cls = pred_a4nc[..., 4:]
    return boxes, cls.amax(-1), torch.argmax(cls, -1).to(torch.int32)


@functools.lru_cache(maxsize=16)
def _scalar(value: float, device: torch.device):
    return constant_on(torch.tensor([value], dtype=torch.float32), device)
