"""Shared decoder components of the SceneSeg model family, the port of
autoware_vision_pilot_tpu/models/components.py. Attribute names are the
JAX package's (and the reference torch modules'), so state_dict keys read
``SceneContext.context_layer_0.weight``, ``SceneNeck.upsample_layer_0.weight``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Conv2d, ConvTranspose2d, Dropout, Linear, gelu, max_pool2d


class ContextBlock(nn.Module):
    """Global context attention: mean-pool -> MLP (in_ch->800->800->
    ctx_h*ctx_w, GELU, sigmoid) -> a (ctx_h, ctx_w) map -> conv stack back
    to in_ch -> ``context * x + x``. In train mode a dropout of 0.25 follows
    each Linear, before its activation; it is the identity at eval."""

    def __init__(self, in_ch=1280, ctx_h=10, ctx_w=20, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ctx_hw = (ctx_h, ctx_w)
        self.context_layer_0 = Linear(in_ch, 800, **kw)
        self.context_layer_1 = Linear(800, 800, **kw)
        self.context_layer_2 = Linear(800, ctx_h * ctx_w, **kw)
        self.context_layer_3 = Conv2d(1, 128, 3, 1, 1, **kw)
        self.context_layer_4 = Conv2d(128, 256, 3, 1, 1, **kw)
        self.context_layer_5 = Conv2d(256, 512, 3, 1, 1, **kw)
        self.context_layer_6 = Conv2d(512, in_ch, 3, 1, 1, **kw)
        self.drop = Dropout(0.25)

    def forward(self, x):
        c = gelu(self.drop(self.context_layer_0(x.mean((2, 3)))))
        c = gelu(self.drop(self.context_layer_1(c)))
        c = self.drop(self.context_layer_2(c)).sigmoid()
        c = c.reshape(-1, 1, *self.ctx_hw)
        c = gelu(self.context_layer_3(c))
        c = gelu(self.context_layer_4(c))
        c = gelu(self.context_layer_5(c))
        c = gelu(self.context_layer_6(c))
        return c * x + x


class UNeck(nn.Module):
    """3-stage transposed-conv neck with 1x1 skip links from the pyramid.
    (B, in_ch, h, w) -> (B, 256, 8h, 8w)."""

    def __init__(self, in_ch=1280, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.upsample_layer_0 = ConvTranspose2d(in_ch, in_ch, **kw)
        self.skip_link_layer_0 = Conv2d(80, in_ch, 1, **kw)
        self.decode_layer_0 = Conv2d(in_ch, 768, 3, 1, 1, **kw)
        self.decode_layer_1 = Conv2d(768, 768, 3, 1, 1, **kw)
        self.upsample_layer_1 = ConvTranspose2d(768, 768, **kw)
        self.skip_link_layer_1 = Conv2d(40, 768, 1, **kw)
        self.decode_layer_2 = Conv2d(768, 512, 3, 1, 1, **kw)
        self.decode_layer_3 = Conv2d(512, 512, 3, 1, 1, **kw)
        self.upsample_layer_2 = ConvTranspose2d(512, 512, **kw)
        self.skip_link_layer_2 = Conv2d(24, 512, 1, **kw)
        self.decode_layer_4 = Conv2d(512, 512, 3, 1, 1, **kw)
        self.decode_layer_5 = Conv2d(512, 256, 3, 1, 1, **kw)

    def forward(self, context, features):
        d = self.upsample_layer_0(context) + self.skip_link_layer_0(features[3])
        d = gelu(self.decode_layer_0(d))
        d = gelu(self.decode_layer_1(d))
        d = self.upsample_layer_1(d) + self.skip_link_layer_1(features[2])
        d = gelu(self.decode_layer_2(d))
        d = gelu(self.decode_layer_3(d))
        d = self.upsample_layer_2(d) + self.skip_link_layer_2(features[1])
        d = gelu(self.decode_layer_4(d))
        return gelu(self.decode_layer_5(d))


class SegHead(nn.Module):
    """2-stage upsampling head (SceneSegHead out_ch=3, DomainSegHead
    out_ch=1); ``last_ch`` is the width of decode_layer_9."""

    def __init__(self, out_ch=3, *, last_ch=64, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.upsample_layer_3 = ConvTranspose2d(256, 256, **kw)
        self.skip_link_layer_3 = Conv2d(32, 256, 1, **kw)
        self.decode_layer_6 = Conv2d(256, 256, 3, 1, 1, **kw)
        self.decode_layer_7 = Conv2d(256, 128, 3, 1, 1, **kw)
        self.upsample_layer_4 = ConvTranspose2d(128, 128, **kw)
        self.decode_layer_8 = Conv2d(128, 128, 3, 1, 1, **kw)
        self.decode_layer_9 = Conv2d(128, last_ch, 3, 1, 1, **kw)
        self.decode_layer_10 = Conv2d(last_ch, out_ch, 3, 1, 1, **kw)

    def forward(self, neck, features):
        d = self.upsample_layer_3(neck) + self.skip_link_layer_3(features[0])
        d = gelu(self.decode_layer_6(d))
        d = gelu(self.decode_layer_7(d))
        d = self.upsample_layer_4(d)
        d = gelu(self.decode_layer_8(d))
        d = gelu(self.decode_layer_9(d))
        return self.decode_layer_10(d)


class DepthHead(SegHead):
    """Scene3DHead: the SegHead with a 128-wide last block and 1 output."""

    def __init__(self, *, device=None, dtype=None):
        super().__init__(1, last_ch=128, device=device, dtype=dtype)


class BackboneFeatureFusion(nn.Module):
    """Max-pool every pyramid level to stride 32 and concat channels:
    32+24+40+80+1280 = 1456."""

    def forward(self, features):
        pooled = []
        for level, f in enumerate(features[:4]):
            for _ in range(4 - level):
                f = max_pool2d(f, 2, 2)
            pooled.append(f)
        return torch.cat([*pooled, features[4]], dim=1)


class EgoLanesHead(nn.Module):
    """Quarter-res 3-class lane head."""

    def __init__(self, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.decode_layer_6 = Conv2d(256, 256, 3, 1, 1, **kw)
        self.decode_layer_7 = Conv2d(256, 128, 3, 1, 1, **kw)
        self.decode_layer_8 = Conv2d(128, 3, 3, 1, 1, **kw)

    def forward(self, neck):
        d = gelu(self.decode_layer_6(neck))
        d = gelu(self.decode_layer_7(d))
        return self.decode_layer_8(d)
