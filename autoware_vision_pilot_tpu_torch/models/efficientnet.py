"""EfficientNet-B0 feature pyramid, the port of
autoware_vision_pilot_tpu/models/efficientnet.py::EfficientNetB0Features.

Returns [l0, l2, l3, l4, l8] (strides 2/4/8/16/32; channels 32/24/40/80/
1280). Keys follow torchvision's ``features`` layout under ``encoder``:
``encoder.{stage}.{block}.block.{k}.{l}``, the stem at ``encoder.0`` and the
head conv at ``encoder.8`` for any number of stages. Stochastic depth is
the identity at eval and is left out.
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

    def __init__(self, cin, cout, k, stride=1, groups=1, act=True, *,
                 device=None, dtype=None):
        kw = dict(device=device, dtype=dtype)
        layers = [Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups,
                         bias=False, **kw),
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
    def __init__(self, in_ch, out_ch, expand_ratio, kernel, stride, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ce = in_ch * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBN(in_ch, ce, 1, **kw))
        layers.append(ConvBN(ce, ce, kernel, stride, groups=ce, **kw))
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
