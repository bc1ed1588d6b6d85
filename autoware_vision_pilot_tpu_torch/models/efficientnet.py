"""EfficientNet feature pyramids, the port of
autoware_vision_pilot_tpu/models/efficientnet.py.

``EfficientNetB0Features`` returns [l0, l2, l3, l4, l8] (strides 2/4/8/16/
32; channels 32/24/40/80/1280). Keys follow torchvision's ``features``
layout under ``encoder``: ``encoder.{stage}.{block}.block.{k}.{l}``, the
stem at ``encoder.0`` and the head conv at ``encoder.8`` for any number of
stages.

``EfficientNetEncoder`` is the Lite models' encoder: B0 or B1 stages, and
an output stride of 8, 16 or 32 (the stride-2 stages past it become
dilations). Keys ``stem.{0,1}`` and ``s{stage}.{block}.block.{k}.{l}``.

Stochastic depth is the identity at eval and is left out.
"""
from __future__ import annotations

from torch import nn

from ..nn.layers import BatchNorm2d, Conv2d, silu

# (expand_ratio, out_channels, num_blocks, first_stride, kernel)
B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
# EfficientNet-B1: the same widths, deeper stages (torchvision's b1)
B1_STAGES = (
    (1, 16, 2, 1, 3),
    (6, 24, 3, 2, 3),
    (6, 40, 3, 2, 5),
    (6, 80, 4, 2, 3),
    (6, 112, 4, 1, 5),
    (6, 192, 5, 2, 5),
    (6, 320, 2, 1, 3),
)
# Minimal pyramid with the same taps and strides, for fast tests.
B0_DRYRUN_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 1, 2, 3),
    (6, 40, 1, 2, 3),
    (6, 80, 1, 2, 3),
    (6, 160, 1, 2, 3),
)


class ConvBN(nn.Sequential):
    """Conv2d (no bias) + BatchNorm2d (+ SiLU): keys ``0.*`` and ``1.*``."""

    def __init__(self, cin, cout, k, stride=1, groups=1, act=True, dilation=1, *,
                 device=None, dtype=None):
        kw = dict(device=device, dtype=dtype)
        layers = [Conv2d(cin, cout, k, stride, (k - 1) // 2 * dilation, groups=groups,
                         bias=False, dilation=dilation, **kw),
                  BatchNorm2d(cout, **kw)]
        if act:
            layers.append(nn.SiLU())
        super().__init__(*layers)


class SqueezeExcitation(nn.Module):
    def __init__(self, ch, squeeze_ch, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = Conv2d(ch, squeeze_ch, 1, device=device, dtype=dtype)
        self.fc2 = Conv2d(squeeze_ch, ch, 1, device=device, dtype=dtype)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = self.fc2(silu(self.fc1(s)))
        return x * s.sigmoid()


class MBConv(nn.Module):
    """``dilation`` > 1 dilates the depthwise conv (the Lite encoder's
    stages past its output stride)."""

    def __init__(self, in_ch, out_ch, expand_ratio, kernel, stride, dilation=1, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ce = in_ch * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBN(in_ch, ce, 1, **kw))
        layers.append(ConvBN(ce, ce, kernel, stride, groups=ce, dilation=dilation, **kw))
        # squeeze on the block *input* channels // 4
        layers.append(SqueezeExcitation(ce, max(1, in_ch // 4), **kw))
        layers.append(ConvBN(ce, out_ch, 1, act=False, **kw))
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = self.block(x)
        return h + x if self.residual else h


class EfficientNetB0Features(nn.Module):
    def __init__(self, stages=B0_STAGES, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        encoder = {"0": ConvBN(3, 32, 3, 2, **kw)}
        cin = 32
        for i, (t, c, n, s, k) in enumerate(stages, start=1):
            blocks = []
            for j in range(n):
                blocks.append(MBConv(cin, c, t, k, s if j == 0 else 1, **kw))
                cin = c
            encoder[str(i)] = nn.Sequential(*blocks)
        encoder["8"] = ConvBN(cin, 1280, 1, **kw)
        self.encoder = nn.ModuleDict(encoder)
        self.num_stages = len(stages)

    def forward(self, x):
        l0 = h = self.encoder["0"](x)
        outs = {}
        for i in range(1, self.num_stages + 1):
            h = outs[i] = self.encoder[str(i)](h)
        l8 = self.encoder["8"](h)
        return [l0, outs[2], outs[3], outs[4], l8]


class EfficientNetEncoder(nn.Module):
    """The Lite models' encoder: ``stages`` (B0_STAGES or B1_STAGES) with
    an ``output_stride`` of 8, 16 or 32. Once the stride reaches it, each
    stride-2 stage keeps the stride and doubles the dilation. Returns
    [s2 (32 ch), s4 (24), s8 (40), s16' (112), s32' (320)], the features
    after the stem and after stages 2, 3, 5 and 7 (primes: at most
    ``output_stride``)."""

    def __init__(self, stages=B0_STAGES, output_stride=32, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.stem = ConvBN(3, 32, 3, 2, **kw)
        cin, cur_stride, dilation = 32, 2, 1
        for i, (t, c, n, s, k) in enumerate(stages, start=1):
            blocks = []
            for j in range(n):
                stride = s if j == 0 else 1
                if stride == 2 and cur_stride >= output_stride:
                    stride, dilation = 1, dilation * 2  # keep the receptive field
                elif stride == 2:
                    cur_stride *= 2
                blocks.append(MBConv(cin, c, t, k, stride, dilation, **kw))
                cin = c
            self.add_module(f"s{i}", nn.Sequential(*blocks))
        self.num_stages = len(stages)

    def forward(self, x):
        feats = [h := self.stem(x)]
        for i in range(1, self.num_stages + 1):
            h = getattr(self, f"s{i}")(h)
            if i in (2, 3, 5, 7):
                feats.append(h)
        return feats
