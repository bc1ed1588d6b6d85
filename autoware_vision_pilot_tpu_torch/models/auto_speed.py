"""AutoSpeed, the YOLOv11-style object detector of the longitudinal program,
the port of autoware_vision_pilot_tpu/models/auto_speed.py: a CTX backbone,
a PAN-FPN neck, and a decoupled DFL box + depthwise class head whose
inference decode gives (B, A, 4 + nc): xywh in input pixels and sigmoid
class scores.

Modules take NCHW (channels_last in the pipeline); the decode flattens each
level in the JAX package's NHWC (h, w) order, so anchors line up.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
from torch import nn

from ..nn.layers import Conv2d, upsample2x_nearest
from ..ops.device import constant_on
from .yolo_layers import C2PSA, C3K2, CTX, SPPF, YoloConv, dfl_decode

# variant name -> (csp pair, depth, width), as the JAX package's
VARIANTS = {
    "n": {"csp": (False, True), "depth": (1,) * 6, "width": (3, 16, 32, 64, 128, 256)},
    "s": {"csp": (False, True), "depth": (1,) * 6, "width": (3, 32, 64, 128, 256, 512)},
    "m": {"csp": (True, True), "depth": (1,) * 6, "width": (3, 64, 128, 256, 512, 512)},
    "l": {"csp": (True, True), "depth": (2,) * 6, "width": (3, 64, 128, 256, 512, 512)},
    "x": {"csp": (True, True), "depth": (2,) * 6, "width": (3, 96, 192, 384, 768, 768)},
}

# the reference builds CTX spatial maps for a 512x1024 input
DEFAULT_H, DEFAULT_W = 512, 1024


class AutoSpeedBackbone(nn.Module):
    def __init__(self, width, depth, csp, img_h=DEFAULT_H, img_w=DEFAULT_W, **kw):
        super().__init__()
        W, h, w = width, img_h, img_w
        self.p1 = YoloConv(W[0], W[1], 3, 2, 1, **kw)
        self.p2_0 = YoloConv(W[1], W[2], 3, 2, 1, **kw)
        self.p2_1 = CTX(W[2], W[3], 2, h // 4, w // 4, **kw)
        self.p3_0 = YoloConv(W[3], W[3], 3, 2, 1, **kw)
        self.p3_1 = CTX(W[3], W[4], 2, h // 8, w // 8, **kw)
        self.p4_0 = YoloConv(W[4], W[4], 3, 2, 1, **kw)
        self.p4_1 = CTX(W[4], W[4], 2, h // 16, w // 16, **kw)
        self.p5_0 = YoloConv(W[4], W[5], 3, 2, 1, **kw)
        self.p5_1 = CTX(W[5], W[5], 2, h // 32, w // 32, **kw)
        self.p5_2 = SPPF(W[5], W[5], **kw)
        self.p5_3 = C2PSA(W[5], W[5], **kw)

    def pyramid(self, x):
        """-> (p2, p3, p4, p5)."""
        p2 = self.p2_1(self.p2_0(self.p1(x)))
        p3 = self.p3_1(self.p3_0(p2))
        p4 = self.p4_1(self.p4_0(p3))
        p5 = self.p5_3(self.p5_2(self.p5_1(self.p5_0(p4))))
        return p2, p3, p4, p5

    def forward(self, x):
        return self.pyramid(x)[1:]


def top_down(h1, h2, p3, p4, p5):
    """The neck's two top-down stages: p5 -> h1 (with p4) -> h2 (with p3)
    -> (p3, p4)."""
    p4 = h1(torch.cat([upsample2x_nearest(p5), p4], 1))
    p3 = h2(torch.cat([upsample2x_nearest(p4), p3], 1))
    return p3, p4


class AutoSpeedNeck(nn.Module):
    def __init__(self, width, depth, csp, **kw):
        super().__init__()
        W, D, C = width, depth, csp
        self.h1 = C3K2(W[5] + W[4], W[4], D[5], C[0], 2, **kw)
        self.h2 = C3K2(W[4] + W[4], W[3], D[5], C[0], 2, **kw)
        self.h3 = YoloConv(W[3], W[3], 3, 2, 1, **kw)
        self.h4 = C3K2(W[3] + W[4], W[4], D[5], C[0], 2, **kw)
        self.h5 = YoloConv(W[4], W[4], 3, 2, 1, **kw)
        self.h6 = C3K2(W[4] + W[5], W[5], D[5], C[1], 2, **kw)

    def forward(self, feats):
        p3, p4, p5 = feats
        p3, p4 = top_down(self.h1, self.h2, p3, p4, p5)
        p4 = self.h4(torch.cat([self.h3(p3), p4], 1))
        p5 = self.h6(torch.cat([self.h5(p4), p5], 1))
        return p3, p4, p5


def make_anchors(shapes, strides, dtype=torch.float32, offset: float = 0.5):
    """Anchor centres (A, 2) [x, y] and per-anchor stride (A, 1),
    concatenated over levels, each level in (h, w) row-major order."""
    anchors, strs = [], []
    for (h, w), s in zip(shapes, strides):
        sx = torch.arange(w, dtype=dtype) + offset
        sy = torch.arange(h, dtype=dtype) + offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        anchors.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        strs.append(torch.full((h * w, 1), s, dtype=dtype))
    return torch.cat(anchors), torch.cat(strs)


@functools.lru_cache(maxsize=8)
def device_anchors(shapes: Tuple[Tuple[int, int], ...], strides: Tuple[int, ...],
                   dtype: torch.dtype, device: torch.device):
    """``make_anchors`` on ``device``, built once per geometry."""
    return tuple(constant_on(t, device) for t in make_anchors(shapes, strides, dtype))


class AutoSpeedHead(nn.Module):
    def __init__(self, nc=4, filters: Sequence[int] = (64, 128, 256),
                 strides: Sequence[int] = (8, 16, 32), ch=16, **kw):
        super().__init__()
        self.nc, self.ch, self.strides = nc, ch, tuple(strides)
        box_ch = max(64, filters[0] // 4)
        cls_ch = max(80, filters[0], nc)
        for i, f in enumerate(filters):
            setattr(self, f"box_{i}_0", YoloConv(f, box_ch, 3, p=1, **kw))
            setattr(self, f"box_{i}_1", YoloConv(box_ch, box_ch, 3, p=1, **kw))
            setattr(self, f"box_{i}_2", Conv2d(box_ch, 4 * ch, 1, 1, 0, **kw))
            setattr(self, f"cls_{i}_0", YoloConv(f, f, 3, p=1, g=f, **kw))
            setattr(self, f"cls_{i}_1", YoloConv(f, cls_ch, **kw))
            setattr(self, f"cls_{i}_2", YoloConv(cls_ch, cls_ch, 3, p=1, g=cls_ch, **kw))
            setattr(self, f"cls_{i}_3", YoloConv(cls_ch, cls_ch, **kw))
            setattr(self, f"cls_{i}_4", Conv2d(cls_ch, nc, 1, 1, 0, **kw))

    def forward(self, feats):
        """-> (B, A, 4 + nc): xywh * stride and sigmoid class scores."""
        boxes, scores, shapes = [], [], []
        for i, x in enumerate(feats):
            b, c = x, x
            for j in range(3):
                b = getattr(self, f"box_{i}_{j}")(b)
            for j in range(5):
                c = getattr(self, f"cls_{i}_{j}")(c)
            # NHWC flatten, the JAX package's (B, H*W, C) order
            boxes.append(b.permute(0, 2, 3, 1).flatten(1, 2))
            scores.append(c.permute(0, 2, 3, 1).flatten(1, 2))
            shapes.append(tuple(x.shape[2:]))
        box_logits, cls_logits = torch.cat(boxes, 1), torch.cat(scores, 1)
        anchors, strides = device_anchors(tuple(shapes), self.strides, box_logits.dtype,
                                          box_logits.device)
        d = dfl_decode(box_logits, self.ch)  # (B, A, 4) ltrb
        x1y1 = anchors - d[..., :2]
        x2y2 = anchors + d[..., 2:]
        xywh = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)
        return torch.cat([xywh * strides, torch.sigmoid(cls_logits)], -1)


class AutoSpeedNetwork(nn.Module):
    """The detector (attributes net / fpn / head, as the JAX package's)."""

    def __init__(self, variant="n", num_classes=4, img_h=DEFAULT_H, img_w=DEFAULT_W, *,
                 device=None, dtype=None):
        super().__init__()
        cfg = VARIANTS[variant]
        kw = dict(device=device, dtype=dtype)
        W = cfg["width"]
        self.net = AutoSpeedBackbone(W, cfg["depth"], cfg["csp"], img_h, img_w, **kw)
        self.fpn = AutoSpeedNeck(W, cfg["depth"], cfg["csp"], **kw)
        self.head = AutoSpeedHead(num_classes, (W[3], W[4], W[5]), **kw)

    def forward(self, x):
        return self.head(self.fpn(self.net(x)))
