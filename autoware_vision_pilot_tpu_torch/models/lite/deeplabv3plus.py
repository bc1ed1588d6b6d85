"""DeepLabV3+ Lite, the port of
autoware_vision_pilot_tpu/models/lite/deeplabv3plus.py: the EfficientNet
B0/B1 encoder at output stride 8 or 16 (dilated stages), a separable-conv
ASPP (rates 12/24/36 and image pooling), the V3+ decoder with its
stride-4 skip, and a 3x3 head with an optional bilinear upsample and
sigmoid or tanh.

Modules take and return NCHW (channels_last on the card). Attribute names
are the flax module names, so the JAX package's variables load through
convert/from_jax.py. In train mode the BatchNorms use the batch's
statistics and the ASPP's output goes through its dropout (0.5, as JAX's
``aspp_dropout``); in eval mode the dropout is the identity.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import BatchNorm2d, Conv2d, Dropout
from ..efficientnet import B0_STAGES, B1_STAGES, EfficientNetEncoder

ENCODERS = {
    "efficientnet_b0": B0_STAGES,
    "efficientnet_b1": B1_STAGES,
}


def encoder_channels(stages) -> list:
    """The channels of EfficientNetEncoder's five features."""
    return [32] + [stages[i][1] for i in (1, 2, 4, 6)]


class ConvBNReLU(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU. ``separable`` with a window > 1:
    a depthwise conv ``dw`` then a 1x1 ``pw``; else one conv ``conv``."""

    def __init__(self, in_ch, features, kernel=3, dilation=1, separable=False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        pad = (kernel - 1) // 2 * dilation
        self.separable = separable and kernel > 1
        if self.separable:
            self.dw = Conv2d(in_ch, in_ch, kernel, 1, pad, groups=in_ch, bias=False,
                             dilation=dilation, **kw)
            self.pw = Conv2d(in_ch, features, 1, 1, 0, bias=False, **kw)
        else:
            self.conv = Conv2d(in_ch, features, kernel, 1, pad, bias=False,
                               dilation=dilation, **kw)
        self.bn = BatchNorm2d(features, momentum=0.01, **kw)  # flax's default 0.99

    def forward(self, x):
        x = self.pw(self.dw(x)) if self.separable else self.conv(x)
        return F.relu(self.bn(x))


class ASPP(nn.Module):
    """A 1x1 branch, one dilated separable 3x3 branch a rate and image
    pooling (mean, 1x1, broadcast), concatenated and projected by a 1x1
    conv."""

    def __init__(self, in_ch, out_ch=256, rates: Sequence[int] = (12, 24, 36),
                 dropout: float = 0.5, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.b0 = ConvBNReLU(in_ch, out_ch, 1, **kw)
        for i, r in enumerate(rates):
            self.add_module(f"b{i + 1}", ConvBNReLU(in_ch, out_ch, 3, r, separable=True, **kw))
        self.pool = ConvBNReLU(in_ch, out_ch, 1, **kw)
        self.proj = ConvBNReLU((len(rates) + 2) * out_ch, out_ch, 1, **kw)
        self.drop = Dropout(dropout)
        self.num_rates = len(rates)

    def forward(self, x):
        branches = [getattr(self, f"b{i}")(x) for i in range(self.num_rates + 1)]
        g = self.pool(x.mean((2, 3), keepdim=True))
        branches.append(g.expand(-1, -1, *x.shape[2:]))
        return self.drop(self.proj(torch.cat(branches, 1)))


def _resize_to(x, ref):
    """Bilinear resize of ``x`` to the spatial size of ``ref``: every use is
    an upsample, where ``jax.image.resize(..., "bilinear")`` is half-pixel
    linear interpolation, as this is."""
    return F.interpolate(x, size=ref.shape[2:], mode="bilinear", align_corners=False)


def head_output(out, upsampling: int, activation: Optional[str]):
    """The Lite heads' bilinear x ``upsampling`` and activation."""
    if upsampling and upsampling > 1:
        out = F.interpolate(out, size=(out.shape[2] * upsampling, out.shape[3] * upsampling),
                            mode="bilinear", align_corners=False)
    if activation == "sigmoid":
        return out.sigmoid()
    if activation == "tanh":
        return out.tanh()
    return out


class DeepLabV3Plus(nn.Module):
    def __init__(self, encoder_name="efficientnet_b0", output_stride=16,
                 decoder_channels=256, atrous_rates: Sequence[int] = (12, 24, 36),
                 output_channels=3, head_upsampling=4,
                 head_activation: Optional[str] = None, aspp_dropout: float = 0.5, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        stages = ENCODERS[encoder_name]
        ch = encoder_channels(stages)
        self.encoder = EfficientNetEncoder(stages, output_stride, **kw)
        self.aspp = ASPP(ch[-1], decoder_channels, atrous_rates, aspp_dropout, **kw)
        self.low_proj = ConvBNReLU(ch[1], 48, 1, **kw)
        self.fuse = ConvBNReLU(decoder_channels + 48, decoder_channels, 3, separable=True,
                               **kw)
        self.head = Conv2d(decoder_channels, output_channels, 3, 1, 1, **kw)
        self.head_upsampling = head_upsampling
        self.head_activation = head_activation

    def forward(self, x):
        feats = self.encoder(x)
        low, high = feats[1], feats[-1]  # stride 4, stride output_stride
        h = _resize_to(self.aspp(high), low)
        h = self.fuse(torch.cat([h, self.low_proj(low)], 1))
        return head_output(self.head(h), self.head_upsampling, self.head_activation)
