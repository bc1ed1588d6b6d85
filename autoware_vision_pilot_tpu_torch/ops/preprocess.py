"""Frame preprocessing in plain PyTorch, the port of
autoware_vision_pilot_tpu/ops/preprocess.py.

``preprocess_imagenet`` and ``letterbox`` are the plain versions of the
fused-preprocess kernel's two modes (ops/kernels/preprocess_kernel.py) and
perform the kernel's f32 operations in the same order. Functions take and
return NHWC, as the JAX package's do. Resize matches cv2.INTER_LINEAR
(half-pixel sampling, no antialiasing).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .device import constant_on

IMAGENET_MEAN = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float32)
IMAGENET_STD = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float32)
LETTERBOX_PAD = 114  # AutoSpeed's gray (autospeed/onnxruntime_engine.cpp:71-113)


def bilinear_taps(n_in: int, n_out: int):
    """Source indices and weight of half-pixel linear resampling, the
    arithmetic of the JAX package's ``_bilinear_matrix``: output i reads
    ``(1 - frac[i]) * x[i0[i]] + frac[i] * x[i1[i]]``.

    Coordinates are computed in float64 and clipped; frac is cast to f32
    once. Returns (i0 int32, i1 int32, frac float32), each (n_out,).
    """
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    frac = np.clip(src - np.floor(src), 0.0, 1.0)
    frac = np.where(src < 0, 0.0, frac)
    return i0.astype(np.int32), i1.astype(np.int32), frac.astype(np.float32)


@functools.lru_cache(maxsize=16)
def device_taps(n_in: int, n_out: int, device: torch.device):
    """``bilinear_taps`` as tensors on ``device``, built once per shape;
    the plain version and the kernel read the same tables."""
    return tuple(constant_on(torch.from_numpy(a), device)
                 for a in bilinear_taps(n_in, n_out))


@functools.lru_cache(maxsize=4)
def device_mean_std(device: torch.device):
    return constant_on(IMAGENET_MEAN, device), constant_on(IMAGENET_STD, device)


def _lerp(x, dim: int, n_out: int):
    i0, i1, frac = device_taps(x.shape[dim], n_out, x.device)
    frac = frac.reshape(-1, *([1] * (-dim - 1)))
    return x.index_select(dim, i0) * (1 - frac) + x.index_select(dim, i1) * frac


def resize_bilinear(img, out_hw: Tuple[int, int]):
    """cv2.resize(..., INTER_LINEAR) without antialiasing, rows then
    columns, in f32. img: (..., H, W, C) any dtype -> (..., h, w, C) f32."""
    x = img.to(torch.float32)
    x = _lerp(x, -3, out_hw[0])
    return _lerp(x, -2, out_hw[1])


def preprocess_imagenet(frame_bgr_u8, out_hw: Tuple[int, int],
                        dtype=torch.float32):
    """BGR uint8 frame(s) (..., H, W, 3) -> resized, RGB, [0,1],
    ImageNet-normalised (..., h, w, 3) in ``dtype``."""
    x = resize_bilinear(frame_bgr_u8, out_hw).flip(-1)  # BGR -> RGB
    x = x * (1.0 / 255.0)
    mean, std = device_mean_std(x.device)
    return ((x - mean) / std).to(dtype)


def letterbox_geometry(out_hw: Tuple[int, int], orig_hw: Tuple[int, int]):
    """The letterbox of an ``orig_hw`` frame into ``out_hw``, with the JAX
    package's Python arithmetic: -> (scale, (nh, nw) of the resized image,
    (pad_x, pad_y) of its top-left corner)."""
    th, tw = out_hw
    oh, ow = orig_hw
    scale = min(tw / ow, th / oh)
    nw, nh = int(ow * scale), int(oh * scale)
    return scale, (nh, nw), ((tw - nw) // 2, (th - nh) // 2)


def letterbox(frame_bgr_u8, out_hw: Tuple[int, int], orig_hw: Tuple[int, int],
              pad_value: int = LETTERBOX_PAD, dtype=torch.float32):
    """AutoSpeed letterbox: scale to fit, centre-pad with ``pad_value``,
    RGB, [0, 1], in the JAX package's order (resize, pad, flip, * 1/255).
    (..., H, W, 3) uint8 -> ((..., th, tw, 3) ``dtype``, scale, (pad_x,
    pad_y)), scale and pads Python numbers."""
    th, tw = out_hw
    scale, (nh, nw), (pad_x, pad_y) = letterbox_geometry(out_hw, orig_hw)
    x = resize_bilinear(frame_bgr_u8, (nh, nw))
    x = F.pad(x, (0, 0, pad_x, tw - nw - pad_x, pad_y, th - nh - pad_y),
              value=float(pad_value))
    x = x.flip(-1) * (1.0 / 255.0)
    return x.to(dtype), scale, (pad_x, pad_y)
