"""AutoDrive, the port of autoware_vision_pilot_tpu/models/auto_drive.py:
temporal two-frame regression of (normalized CIPO distance, path curvature,
cut-in flag logit). The AutoSpeed "n" backbone (P5 only) runs on both
frames as one batch of 2B; the head concatenates the two P5 maps -> conv
stack -> MLP -> three task branches. Submodule names are the JAX package's
(backbone / head); modules take NCHW.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Conv2d, Dropout, Linear, silu
from .auto_speed import DEFAULT_H, DEFAULT_W, VARIANTS, AutoSpeedBackbone


class AutoDriveBackbone(AutoSpeedBackbone):
    """AutoSpeed's backbone (the same layers and names), returning p5 alone."""

    def forward(self, x):
        return super().forward(x)[2]


class AutoDriveHead(nn.Module):
    """In train mode a dropout of 0.1 follows each of the two hidden layers
    (one flax Dropout called twice, two masks); in eval mode it is the
    identity."""

    def __init__(self, in_channels=256, p5_h=DEFAULT_H // 32, p5_w=DEFAULT_W // 32, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv_1 = Conv2d(2 * in_channels, 256, 3, 1, 1, **kw)
        self.conv_2 = Conv2d(256, 64, 3, 1, 1, **kw)
        self.conv_3 = Conv2d(64, 2, 3, 1, 1, **kw)
        self.fc1_0 = Linear(2 * p5_h * p5_w, 768, **kw)
        self.fc2_0 = Linear(768, 512, **kw)
        self.distance_head_0 = Linear(512, 1, **kw)
        self.curvature_head_0 = Linear(512, 1, **kw)
        self.flag_head = Linear(512, 1, **kw)
        self.drop = Dropout(0.1)

    def forward(self, feat_prev, feat_curr):
        """-> (d_norm, curvature, flag_logit), each (B, 1)."""
        x = torch.cat([feat_prev, feat_curr], 1)
        x = silu(self.conv_1(x))
        x = silu(self.conv_2(x))
        x = silu(self.conv_3(x))
        x = x.reshape(x.shape[0], -1)  # channel-major, as the reference's torch.flatten
        x = self.drop(silu(self.fc1_0(x)))
        x = self.drop(silu(self.fc2_0(x)))
        d_norm = torch.relu(self.distance_head_0(x))
        curvature = torch.tanh(self.curvature_head_0(x))
        return d_norm, curvature, self.flag_head(x)

    @staticmethod
    def to_distance_meters(d_norm):
        return 150.0 * (1.0 - d_norm)


class AutoDriveNetwork(nn.Module):
    """The backbone and head (attributes backbone / head). The CTX blocks
    are built for one input size, ``img_h`` x ``img_w``."""

    def __init__(self, img_h=DEFAULT_H, img_w=DEFAULT_W, *, device=None, dtype=None):
        super().__init__()
        cfg = VARIANTS["n"]
        kw = dict(device=device, dtype=dtype)
        W = cfg["width"]
        self.backbone = AutoDriveBackbone(W, cfg["depth"], cfg["csp"], img_h, img_w, **kw)
        self.head = AutoDriveHead(W[5], img_h // 32, img_w // 32, **kw)

    def forward(self, image_prev, image_curr):
        """(B, 3, img_h, img_w) frames t-1 and t -> (d_norm, curvature,
        flag_logit), each (B, 1)."""
        B = image_prev.shape[0]
        p5 = self.backbone(torch.cat([image_prev, image_curr], 0))
        return self.head(p5[:B], p5[B:])
