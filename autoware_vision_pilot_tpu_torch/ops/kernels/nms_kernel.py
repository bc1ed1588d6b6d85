"""Greedy NMS of sorted candidates: the wrapper of csrc/nms.cu, the port's
counterpart of XLA's lowering of the JAX package's ``nms_fixed`` after its
top-k (autoware_vision_pilot_tpu/ops/postprocess.py:51-111, the greedy
``fori_loop`` at :88-97).

On a CUDA tensor it launches the kernel through its operator
``torch.ops.avp.nms_greedy`` (csrc/torch_ops.cpp), a thread-block cluster of
``cluster_size(k)`` blocks for each stream of a batch, or raises; on a CPU tensor it runs the plain
version, ops/postprocess.py::nms_greedy_plain. The top-k before
it stays a PyTorch sort (ops/postprocess.py::nms_topk), as it is XLA's
``top_k`` in the JAX package.
"""
from __future__ import annotations

import torch

from . import torch_ops
from ..postprocess import nms_greedy_plain, nms_topk

MAX_K = 1248  # 39 words of 32 rows: what one block's shared memory holds (csrc/nms.cu)
MAX_CLUSTER = 8  # the portable thread-block cluster size


def cluster_size(k: int) -> int:
    """The blocks of the kernel's cluster for k candidates: one for each
    32-row word of the suppression matrix, at most 8."""
    return min(MAX_CLUSTER, -(-k // 32))


MAX_STREAMS = 65535  # the grid's y extent


def nms_greedy(top_boxes: torch.Tensor, top_scores: torch.Tensor, top_cls: torch.Tensor, *,
               max_det: int = 64, iou_thresh: float = 0.45, conf_thresh: float = 0.25,
               class_aware: bool = True):
    """``nms_topk``'s candidates, (k, 4) f32, (k,) f32, (k,) int32, or a
    batch of streams (N, k, 4), (N, k), (N, k), on one device -> boxes
    (..., max_det, 4) f32, scores (..., max_det) f32, classes (...,
    max_det) int32, valid (..., max_det) bool: each stream's kept
    candidates in score order, zeros after them. A batch is one launch, a
    cluster a stream, and every stream's result is the one a call on it
    alone gives.

    Counts its kernel launches in ``nms_greedy.launches`` (not the calls
    that torch.export traces).
    """
    if top_boxes.dtype != torch.float32 or top_scores.dtype != torch.float32:
        raise TypeError(f"boxes and scores must be float32, got {top_boxes.dtype}, "
                        f"{top_scores.dtype}")
    if top_cls.dtype != torch.int32:
        raise TypeError(f"classes must be int32, got {top_cls.dtype}")
    lead = tuple(top_scores.shape[:-1]) if top_scores.dim() in (1, 2) else None
    k = top_scores.shape[-1] if top_scores.dim() else 0
    if lead is None or k < 1 or tuple(top_boxes.shape) != (*lead, k, 4) or \
            tuple(top_cls.shape) != (*lead, k) or (lead and lead[0] < 1):
        raise ValueError(f"expected (k, 4), (k,), (k,) or (N, k, 4), (N, k), (N, k) with "
                         f"k >= 1, got {tuple(top_boxes.shape)}, {tuple(top_scores.shape)}, "
                         f"{tuple(top_cls.shape)}")
    if not (isinstance(max_det, int) and max_det >= 1):
        raise ValueError(f"max_det must be a positive int, got {max_det}")
    if not top_boxes.device == top_scores.device == top_cls.device:
        raise ValueError("candidates on different devices")
    device = top_scores.device
    if device.type == "cpu":
        return nms_greedy_plain(top_boxes, top_scores, top_cls, max_det=max_det,
                                iou_thresh=iou_thresh, conf_thresh=conf_thresh,
                                class_aware=class_aware)
    if device.type != "cuda":
        raise ValueError(f"no NMS for device {device}")
    if k > MAX_K:
        raise ValueError(f"{k} candidates: the kernel takes at most {MAX_K}")
    if lead and lead[0] > MAX_STREAMS:
        raise ValueError(f"{lead[0]} streams: the kernel takes at most {MAX_STREAMS}")
    if not (top_boxes.is_contiguous() and top_scores.is_contiguous()
            and top_cls.is_contiguous()):
        raise ValueError("candidates must be contiguous")

    return _launch(top_boxes, top_scores, top_cls, max_det, iou_thresh, conf_thresh,
                   class_aware, cluster_size(k))


def _launch(top_boxes, top_scores, top_cls, max_det, iou_thresh, conf_thresh, class_aware,
            cs, stamps=None):
    """One launch of the kernel, a cluster of ``cs`` blocks a stream, on
    checked CUDA candidates, one stream or a batch. ``stamps``, a (5,)
    int64 CUDA tensor, receives stream 0's block 0's %globaltimer at its
    stages (see csrc/nms.cu); the path passes none."""
    one = top_scores.dim() == 1
    torch_ops.load()
    candidates = (top_boxes, top_scores, top_cls)
    out = torch.ops.avp.nms_greedy(*(t[None] if one else t for t in candidates), max_det,
                                   iou_thresh, conf_thresh, bool(class_aware), cs, stamps)
    if not torch.compiler.is_compiling():  # a trace launches nothing
        nms_greedy.launches += 1
    return tuple(t[0] for t in out) if one else out


nms_greedy.launches = 0


def nms_fixed(boxes_xyxy, scores, class_ids, *, max_det: int = 64, iou_thresh: float = 0.45,
              conf_thresh: float = 0.25, class_aware: bool = True):
    """The JAX package's ``nms_fixed``: ``nms_topk``, then ``nms_greedy``
    (the kernel on the card), for one stream or a batch. (..., A, 4) f32,
    (..., A) f32, (..., A) int32 -> boxes (..., max_det, 4), scores,
    classes, valid (..., max_det)."""
    top = nms_topk(boxes_xyxy, scores, class_ids, max_det=max_det, conf_thresh=conf_thresh)
    return nms_greedy(*top, max_det=max_det, iou_thresh=iou_thresh, conf_thresh=conf_thresh,
                      class_aware=class_aware)
