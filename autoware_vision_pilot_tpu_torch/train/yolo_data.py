"""YOLO-style detection data, the port of
autoware_vision_pilot_tpu/train/yolo_data.py: mosaic, mixup, HSV jitter and
random perspective (the reference's Models/data_utils/
load_data_auto_speed.py: mosaic :105, mixup :388, random_perspective
:330, HSV :280), and the batcher that pads the targets to fixed shapes.

It runs on the host in numpy and cv2, as in the JAX package (the
geometric label bookkeeping is irregular), with a ``np.random.Generator``:
for the same generator state the port's samples are bit-equal to JAX's.
A batch is (images (B, H, W, 3) uint8, boxes (B, M, 4) normalized xywh,
labels (B, M) int32, mask (B, M) bool), what the detection trainer takes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@dataclasses.dataclass
class DetSample:
    image: np.ndarray            # (H, W, 3) uint8
    boxes_xyxy: np.ndarray       # (N, 4) pixels
    labels: np.ndarray           # (N,) int


def hsv_augment(img: np.ndarray, rng, h=0.015, s=0.7, v=0.4) -> np.ndarray:
    r = rng.uniform(-1, 1, 3) * [h, s, v] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    x = np.arange(0, 256, dtype=r.dtype)
    lut_h = ((x * r[0]) % 180).astype(np.uint8)
    lut_s = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_v = np.clip(x * r[2], 0, 255).astype(np.uint8)
    hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s),
                     cv2.LUT(val, lut_v)))
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


def mosaic4(samples: Sequence[DetSample], out_hw: Tuple[int, int],
            rng) -> DetSample:
    """4-image mosaic around a jittered center (load_data_auto_speed:105)."""
    oh, ow = out_hw
    canvas = np.full((oh * 2, ow * 2, 3), 114, np.uint8)
    cx = int(rng.uniform(ow * 0.5, ow * 1.5))
    cy = int(rng.uniform(oh * 0.5, oh * 1.5))
    all_boxes, all_labels = [], []
    corners = [(0, 0, cx, cy), (cx, 0, ow * 2, cy),
               (0, cy, cx, oh * 2), (cx, cy, ow * 2, oh * 2)]
    for s, (x0, y0, x1, y1) in zip(samples, corners):
        tw, th = x1 - x0, y1 - y0
        if tw <= 0 or th <= 0:
            continue
        img = cv2.resize(s.image, (tw, th))
        canvas[y0:y1, x0:x1] = img
        if len(s.boxes_xyxy):
            sx = tw / s.image.shape[1]
            sy = th / s.image.shape[0]
            b = s.boxes_xyxy * [sx, sy, sx, sy] + [x0, y0, x0, y0]
            all_boxes.append(b)
            all_labels.append(s.labels)
    boxes = (np.concatenate(all_boxes) if all_boxes
             else np.zeros((0, 4)))
    labels = (np.concatenate(all_labels) if all_labels
              else np.zeros((0,), np.int64))
    # crop canvas back to out size around its center
    img = cv2.resize(canvas, (ow, oh))
    boxes = boxes * 0.5
    return DetSample(img, boxes, labels)


def mixup(a: DetSample, b: DetSample, rng) -> DetSample:
    lam = np.float32(rng.beta(32.0, 32.0))
    img = (a.image.astype(np.float32) * lam +
           b.image.astype(np.float32) * (1 - lam)).astype(np.uint8)
    return DetSample(
        img,
        np.concatenate([a.boxes_xyxy, b.boxes_xyxy]),
        np.concatenate([a.labels, b.labels]))


def random_perspective(s: DetSample, rng, degrees=0.0, translate=0.1,
                       scale=0.5, shear=0.0) -> DetSample:
    h, w = s.image.shape[:2]
    a = rng.uniform(-degrees, degrees)
    sc = rng.uniform(1 - scale, 1 + scale)
    M = cv2.getRotationMatrix2D((w / 2, h / 2), a, sc)
    M[0, 2] += rng.uniform(0.5 - translate, 0.5 + translate) * w - w / 2
    M[1, 2] += rng.uniform(0.5 - translate, 0.5 + translate) * h - h / 2
    img = cv2.warpAffine(s.image, M, (w, h), borderValue=(114, 114, 114))
    if len(s.boxes_xyxy):
        pts = s.boxes_xyxy[:, [0, 1, 2, 1, 2, 3, 0, 3]].reshape(-1, 2)
        pts = pts @ M[:, :2].T + M[:, 2]
        pts = pts.reshape(-1, 4, 2)
        boxes = np.concatenate([pts.min(1), pts.max(1)], -1)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        keep = ((boxes[:, 2] - boxes[:, 0]) > 2) & \
               ((boxes[:, 3] - boxes[:, 1]) > 2)
        return DetSample(img, boxes[keep], s.labels[keep])
    return DetSample(img, s.boxes_xyxy, s.labels)


def pad_targets(boxes_xyxy: np.ndarray, labels: np.ndarray,
                img_hw: Tuple[int, int], max_boxes: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> normalized xywh (M,4), labels (M,), mask (M,)."""
    h, w = img_hw
    n = min(len(boxes_xyxy), max_boxes)
    out_b = np.zeros((max_boxes, 4), np.float32)
    out_l = np.zeros((max_boxes,), np.int32)
    out_m = np.zeros((max_boxes,), bool)
    if n:
        b = boxes_xyxy[:n]
        cx = (b[:, 0] + b[:, 2]) / 2 / w
        cy = (b[:, 1] + b[:, 3]) / 2 / h
        bw = (b[:, 2] - b[:, 0]) / w
        bh = (b[:, 3] - b[:, 1]) / h
        out_b[:n] = np.stack([cx, cy, bw, bh], -1)
        out_l[:n] = labels[:n]
        out_m[:n] = True
    return out_b, out_l, out_m


class YoloBatcher:
    """dataset: indexable of DetSample. Yields padded training batches with
    mosaic/mixup/perspective/HSV applied."""

    def __init__(self, dataset, input_hw=(512, 1024), batch_size=8,
                 max_boxes=64, mosaic_prob=1.0, mixup_prob=0.15,
                 hsv=True, perspective=True, seed=0):
        self.ds = dataset
        self.input_hw = input_hw
        self.bs = batch_size
        self.max_boxes = max_boxes
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.hsv = hsv
        self.perspective = perspective
        self.rng = np.random.default_rng(seed)

    def _sample(self) -> DetSample:
        rng = self.rng
        n = len(self.ds)
        if rng.uniform() < self.mosaic_prob:
            idx = rng.integers(0, n, 4)
            s = mosaic4([self.ds[i] for i in idx], self.input_hw, rng)
        else:
            s = self.ds[int(rng.integers(0, n))]
            img = cv2.resize(s.image, self.input_hw[::-1])
            sx = self.input_hw[1] / s.image.shape[1]
            sy = self.input_hw[0] / s.image.shape[0]
            s = DetSample(img, s.boxes_xyxy * [sx, sy, sx, sy], s.labels)
        if rng.uniform() < self.mixup_prob:
            idx = rng.integers(0, n, 4)
            s2 = mosaic4([self.ds[i] for i in idx], self.input_hw, rng)
            s = mixup(s, s2, rng)
        if self.perspective:
            s = random_perspective(s, rng)
        if self.hsv:
            s = DetSample(hsv_augment(s.image, rng), s.boxes_xyxy, s.labels)
        return s

    def __iter__(self) -> Iterator:
        while True:
            imgs, bs_, ls_, ms_ = [], [], [], []
            for _ in range(self.bs):
                s = self._sample()
                b, l, m = pad_targets(s.boxes_xyxy, s.labels,
                                      self.input_hw, self.max_boxes)
                imgs.append(s.image)
                bs_.append(b)
                ls_.append(l)
                ms_.append(m)
            yield (np.stack(imgs), np.stack(bs_), np.stack(ls_),
                   np.stack(ms_))
