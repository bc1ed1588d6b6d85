"""AutoSteerTemporalNet, the runtime steering classifier, the port of
autoware_vision_pilot_tpu/models/auto_steer_temporal.py.

It takes the EgoLanes masks of frames t-1 and t stacked to 6 channels and
gives two 61-way logit vectors (prev, current); steering = argmax(current)
- 30 degrees (autosteer_engine.cpp:104-221). Strided conv stack -> the
5x10x32 map (at 80x160) flattened -> fc -> two heads.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Conv2d, Linear, silu

NUM_CLASSES = 61  # steering -30..+30 degrees


def _half(n: int) -> int:
    """Output size of a 3x3 stride-2 conv with padding 1."""
    return (n - 1) // 2 + 1


class AutoSteerTemporalNet(nn.Module):
    def __init__(self, mask_hw=(80, 160), *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.c1 = Conv2d(6, 32, 3, 2, 1, **kw)       # 40x80
        self.c2 = Conv2d(32, 64, 3, 2, 1, **kw)      # 20x40
        self.c3 = Conv2d(64, 128, 3, 2, 1, **kw)     # 10x20
        self.c4 = Conv2d(128, 128, 3, 2, 1, **kw)    # 5x10
        self.c5 = Conv2d(128, 32, 1, 1, 0, **kw)     # 5x10x32
        h, w = mask_hw
        for _ in range(4):
            h, w = _half(h), _half(w)
        self.fc = Linear(32 * h * w, 256, **kw)
        self.head_prev = Linear(256, NUM_CLASSES, **kw)
        self.head_curr = Linear(256, NUM_CLASSES, **kw)

    def forward(self, x):
        """x: (B, 6, H, W) stacked [t-1, t] masks. -> (prev_logits,
        curr_logits), each (B, 61)."""
        h = silu(self.c1(x))
        h = silu(self.c2(h))
        h = silu(self.c3(h))
        h = silu(self.c4(h))
        h = silu(self.c5(h))
        # the JAX package flattens its NHWC map in (h, w, c) order, and fc's
        # rows follow it: flatten the same order, not NCHW's (c, h, w)
        feat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        feat = silu(self.fc(feat))
        return self.head_prev(feat), self.head_curr(feat)


def steering_from_logits(curr_logits):
    """argmax - 30 -> degrees (autosteer_engine.cpp:193-204); ties take the
    first index, as jnp.argmax does."""
    return torch.argmax(curr_logits, dim=-1).to(torch.float32) - 30.0
