"""AutoSteer 2.0, the port of autoware_vision_pilot_tpu/models/auto_steer.py:
lane/path vector regression on 512x1024 frames. The AutoSpeed-style CTX
backbone (returning p2..p5), a 2-stage top-down neck, and the percept head
that regresses a normalized lane-position vector with a column soft-argmax
plus a lane-height map. Submodule names are the JAX package's (net / fpn /
head); modules take and return NCHW.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Conv2d, silu, upsample2x_nearest
from .auto_speed import DEFAULT_H, DEFAULT_W, VARIANTS, AutoSpeedBackbone, top_down
from .yolo_layers import C3K2, YoloConv


class AutoSteerBackbone(AutoSpeedBackbone):
    """AutoSpeed's backbone (the same layers and names), returning p2 too."""

    forward = AutoSpeedBackbone.pyramid


class AutoSteerNeck(nn.Module):
    """AutoSpeed's first two top-down stages (h1, h2): (p2..p5) -> (p2, p3)."""

    def __init__(self, width, depth, csp, **kw):
        super().__init__()
        W, D, C = width, depth, csp
        self.h1 = C3K2(W[5] + W[4], W[4], D[5], C[0], 2, **kw)
        self.h2 = C3K2(W[4] + W[4], W[3], D[5], C[0], 2, **kw)

    def forward(self, feats):
        p2, p3, p4, p5 = feats
        return p2, top_down(self.h1, self.h2, p3, p4, p5)[0]


class AutoSteerPerceptHead(nn.Module):
    """Vertical 2x1 compression convs, feature concat, then (a) the column
    soft-argmax lane position in [0, 1) and (b) a 16x-compressed lane-height
    map. ``in_ch`` is the width the JAX module is given (its c4 = in_ch / 4
    output channels of v1, v2); ``p_ch`` the channels of p2 and p3."""

    def __init__(self, in_ch, p_ch, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c4 = in_ch // 4
        self.v1 = Conv2d(p_ch, c4, (2, 1), (2, 1), 0, **kw)
        self.v2 = Conv2d(p_ch, c4, (2, 1), (2, 1), 0, **kw)
        self.c1 = YoloConv(2 * c4, 1, 3, 1, 1, **kw)
        self.c2 = YoloConv(2 * c4, 1, 3, 1, 1, **kw)
        self.h1 = Conv2d(1, 1, (1, 16), (1, 16), 0, **kw)
        self.h2 = Conv2d(1, 1, (1, 16), (1, 16), 0, **kw)

    def forward(self, feats):
        """-> (lane_value (B, 1, Hd, 1), height (B, 1, Hd, Wd / 256))."""
        p2, p3 = feats
        p2 = silu(self.v1(p2))
        p3 = silu(self.v2(p3))
        features = torch.cat([upsample2x_nearest(p3), p2], 1)

        lanes = silu(self.c1(features))
        lanes = torch.softmax(lanes, dim=3)  # over W: the JAX package's NHWC axis 2
        Wd = lanes.shape[3]
        cols = torch.arange(Wd, dtype=lanes.dtype, device=lanes.device)
        lane_value = (lanes * cols).sum(3, keepdim=True) / Wd  # divided after the sum

        height = silu(self.c2(features))
        height = silu(self.h1(height))
        height = silu(self.h2(height))
        return lane_value, height


class AutoSteerNetwork(nn.Module):
    """AutoSteer 2.0 (attributes net / fpn / head). The CTX blocks are built
    for one input size, ``img_h`` x ``img_w``."""

    def __init__(self, variant="n", img_h=DEFAULT_H, img_w=DEFAULT_W, *, device=None,
                 dtype=None):
        super().__init__()
        cfg = VARIANTS[variant]
        kw = dict(device=device, dtype=dtype)
        W = cfg["width"]
        self.net = AutoSteerBackbone(W, cfg["depth"], cfg["csp"], img_h, img_w, **kw)
        self.fpn = AutoSteerNeck(W, cfg["depth"], cfg["csp"], **kw)
        self.head = AutoSteerPerceptHead(W[4], W[3], **kw)

    def forward(self, x):
        """x: (B, 3, img_h, img_w) -> (lane_value (B, 1, img_h / 8, 1),
        height (B, 1, img_h / 8, img_w / 1024))."""
        return self.head(self.fpn(self.net(x)))
