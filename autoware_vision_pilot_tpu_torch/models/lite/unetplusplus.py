"""UNet++ Lite, the port of
autoware_vision_pilot_tpu/models/lite/unetplusplus.py: the nested
dense-skip decoder X[i][j] = block(cat(X[i][0..j-1], up(X[i+1][j-1]))) over
the EfficientNet encoder at output stride 32, two 3x3 ConvBNReLU a node
(``x_{i}_{j}_a``, ``x_{i}_{j}_b``), the decoder width indexed by row, and
the Lite head.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...nn.layers import Conv2d
from ..efficientnet import EfficientNetEncoder
from .deeplabv3plus import ENCODERS, ConvBNReLU, _resize_to, encoder_channels, head_output


class UnetPlusPlus(nn.Module):
    def __init__(self, encoder_name="efficientnet_b0",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32), output_channels=3,
                 head_upsampling=2, head_activation: Optional[str] = None, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        stages = ENCODERS[encoder_name]
        self.encoder = EfficientNetEncoder(stages, 32, **kw)
        self.rows = rows = 5  # pyramid rows: 0 (stride 2) .. 4 (stride 32)
        width = {(i, 0): c for i, c in enumerate(encoder_channels(stages))}
        for j in range(1, rows):
            for i in range(rows - j):
                ch = decoder_channels[min(i, len(decoder_channels) - 1)]
                cin = sum(width[(i, k)] for k in range(j)) + width[(i + 1, j - 1)]
                self.add_module(f"x_{i}_{j}_a", ConvBNReLU(cin, ch, 3, **kw))
                self.add_module(f"x_{i}_{j}_b", ConvBNReLU(ch, ch, 3, **kw))
                width[(i, j)] = ch
        self.head = Conv2d(width[(0, rows - 1)], output_channels, 3, 1, 1, **kw)
        self.head_upsampling = head_upsampling
        self.head_activation = head_activation

    def forward(self, x):
        grid = {(i, 0): f for i, f in enumerate(self.encoder(x))}
        for j in range(1, self.rows):
            for i in range(self.rows - j):
                up = _resize_to(grid[(i + 1, j - 1)], grid[(i, 0)])
                cat = torch.cat([grid[(i, k)] for k in range(j)] + [up], 1)
                h = getattr(self, f"x_{i}_{j}_a")(cat)
                grid[(i, j)] = getattr(self, f"x_{i}_{j}_b")(h)
        out = self.head(grid[(0, self.rows - 1)])
        return head_output(out, self.head_upsampling, self.head_activation)
