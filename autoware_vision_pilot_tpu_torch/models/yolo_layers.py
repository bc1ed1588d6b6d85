"""YOLOv11-style building blocks, the port of
autoware_vision_pilot_tpu/models/yolo_layers.py: ConvBN, the CSP/C3K2
bottleneck stacks, the SPPF pooling pyramid, PSA and C2PSA local attention,
the CTX global-context block and the DFL box decode.

Modules take and return NCHW (channels_last in the pipeline). Attribute
names are the flax module names, so the JAX package's variables load through
convert/from_jax.py. Eval mode only.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from ..nn.layers import BatchNorm2d, Conv1dCenter, Conv2d, max_pool2d, silu
from ..ops.device import constant_on

BN_EPS = 0.001


class YoloConv(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3) + SiLU or identity."""

    def __init__(self, in_ch, out_ch, k=1, s=1, p=0, g=1, act="silu", *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv = Conv2d(in_ch, out_ch, k, s, p, groups=g, bias=False, **kw)
        self.norm = BatchNorm2d(out_ch, eps=BN_EPS, **kw)
        self.act = act

    def forward(self, x):
        y = self.norm(self.conv(x))
        return silu(y) if self.act == "silu" else y


class Residual(nn.Module):
    def __init__(self, ch, e=0.5, **kw):
        super().__init__()
        self.conv1 = YoloConv(ch, int(ch * e), 3, p=1, **kw)
        self.conv2 = YoloConv(int(ch * e), ch, 3, p=1, **kw)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class C3K(nn.Module):
    """CSP bottleneck with 2 residual blocks."""

    def __init__(self, in_ch, out_ch, **kw):
        super().__init__()
        half = out_ch // 2
        self.conv1 = YoloConv(in_ch, half, **kw)
        self.res_m_0 = Residual(half, e=1.0, **kw)
        self.res_m_1 = Residual(half, e=1.0, **kw)
        self.conv2 = YoloConv(in_ch, half, **kw)
        self.conv3 = YoloConv(2 * half, out_ch, **kw)

    def forward(self, x):
        y = self.res_m_1(self.res_m_0(self.conv1(x)))
        return self.conv3(torch.cat([y, self.conv2(x)], 1))


class C3K2(nn.Module):
    """CSP stage: split, n bottlenecks on the running half, concat all."""

    def __init__(self, in_ch, out_ch, n=1, csp=False, r=2, **kw):
        super().__init__()
        self.c = c = out_ch // r
        self.n = n
        self.conv1 = YoloConv(in_ch, 2 * c, **kw)
        for i in range(n):
            setattr(self, f"res_m_{i}", C3K(c, c, **kw) if csp else Residual(c, **kw))
        self.conv2 = YoloConv((2 + n) * c, out_ch, **kw)

    def forward(self, x):
        ys = list(self.conv1(x).split(self.c, 1))
        for i in range(self.n):
            ys.append(getattr(self, f"res_m_{i}")(ys[-1]))
        return self.conv2(torch.cat(ys, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 cascaded 5x5 max pools + concat."""

    def __init__(self, in_ch, out_ch, k=5, **kw):
        super().__init__()
        self.k = k
        self.cv1 = YoloConv(in_ch, in_ch // 2, **kw)
        self.cv2 = YoloConv(4 * (in_ch // 2), out_ch, **kw)

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool2d(x, self.k, 1, self.k // 2)
        y2 = max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class Attention(nn.Module):
    """Local self-attention over the spatial map. The qkv channels split as
    torch's channel-major view (B, heads, 2 dk + dh, HW) does, and the
    logits are scaled after the q.k product, as the JAX package computes
    them (so no fused attention call)."""

    def __init__(self, ch, num_head, **kw):
        super().__init__()
        self.nh = num_head
        self.dh = ch // num_head
        self.dk = self.dh // 2
        self.scale = self.dk ** -0.5
        self.qkv = YoloConv(ch, ch + self.dk * num_head * 2, act="identity", **kw)
        self.conv1 = YoloConv(ch, ch, 3, p=1, g=ch, act="identity", **kw)
        self.conv2 = YoloConv(ch, ch, act="identity", **kw)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv(x).reshape(b, self.nh, 2 * self.dk + self.dh, h * w)
        q, k, v = qkv.split([self.dk, self.dk, self.dh], 2)
        attn = torch.softmax((q.transpose(-2, -1) @ k) * self.scale, -1)  # (b, nh, q, p)
        o = (v @ attn.transpose(-2, -1)).reshape(b, c, h, w)
        o = o + self.conv1(v.reshape(b, c, h, w))
        return self.conv2(o)


class PSABlock(nn.Module):
    def __init__(self, ch, num_head, **kw):
        super().__init__()
        self.conv1 = Attention(ch, num_head, **kw)
        self.conv2_0 = YoloConv(ch, 2 * ch, **kw)
        self.conv2_1 = YoloConv(2 * ch, ch, act="identity", **kw)

    def forward(self, x):
        x = x + self.conv1(x)
        return x + self.conv2_1(self.conv2_0(x))


class PSA(nn.Module):
    """Split in two halves, ``n`` PSABlocks (``ch // 128`` heads) on the
    second, concatenate, 1x1. No network of the repo uses it; it completes
    the module."""

    def __init__(self, ch, n=1, **kw):
        super().__init__()
        self.half = half = ch // 2
        self.conv1 = YoloConv(ch, 2 * half, **kw)
        self.res_m = nn.Sequential(*(PSABlock(half, ch // 128, **kw) for _ in range(n)))
        self.conv2 = YoloConv(2 * half, ch, **kw)

    def forward(self, x):
        a, b = self.conv1(x).split(self.half, 1)
        return self.conv2(torch.cat([a, self.res_m(b)], 1))


class C2PSA(nn.Module):
    def __init__(self, in_ch, out_ch, e=0.5, **kw):
        super().__init__()
        self.c = c = int(in_ch * e)
        self.cv1 = YoloConv(in_ch, 2 * c, **kw)
        self.middle_block = PSABlock(c, c // 64, **kw)
        self.cv2 = YoloConv(2 * c, out_ch, **kw)

    def forward(self, x):
        a, b = self.cv1(x).split(self.c, 1)
        return self.cv2(torch.cat([a, self.middle_block(b)], 1))


class CTX(nn.Module):
    """The reference's global-context block: mean-pool -> Conv1d(in_ch ->
    h*w) on a length-1 sequence (its centre tap) -> an (h, w) map -> 2
    convs -> gated attention on the input -> out conv. Built for one input
    size: the map's (h, w) must be the input's."""

    def __init__(self, in_ch, out_ch, r=2, h=16, w=32, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.h, self.w = h, w
        self.exp0 = Conv1dCenter(in_ch, h * w, **kw)
        self.ctx0 = Conv2d(1, in_ch // r, 3, 1, 1, **kw)
        self.ctx1 = Conv2d(in_ch // r, in_ch, 3, 1, 1, **kw)
        self.ctx2 = Conv2d(in_ch, out_ch, 3, 1, 1, **kw)

    def forward(self, x):
        b, _, hh, ww = x.shape
        c0 = silu(self.exp0(x.mean(dim=(2, 3))))
        c1 = silu(c0.reshape(b, 1, self.h, self.w))
        c4 = silu(self.ctx1(silu(self.ctx0(c1))))
        assert (hh, ww) == (self.h, self.w), (
            f"CTX configured for {(self.h, self.w)}, got {(hh, ww)}")
        return self.ctx2(silu(c4 * x + x))


@functools.lru_cache(maxsize=8)
def _bins(ch: int, dtype: torch.dtype, device: torch.device):
    return constant_on(torch.arange(ch, dtype=dtype), device)


def dfl_decode(box_logits, ch: int = 16):
    """Distribution Focal Loss decode: (B, A, 4 * ch) logits -> (B, A, 4)
    expected offsets, the softmax over ch bins times 0..ch-1."""
    b, a, _ = box_logits.shape
    p = torch.softmax(box_logits.reshape(b, a, 4, ch), -1)
    return p @ _bins(ch, p.dtype, p.device)
