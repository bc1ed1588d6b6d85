"""Fused frame preprocessing: the wrapper of csrc/preprocess.cu, the port of
autoware_vision_pilot_tpu/ops/pallas/preprocess_kernel.py::
fused_preprocess_pallas, and, as a mode of the same kernel, of XLA's fusion
of autoware_vision_pilot_tpu/ops/preprocess.py::letterbox.

On a CUDA tensor each function launches the kernel, or raises; on a CPU
tensor it runs the plain version (ops/preprocess.py::preprocess_imagenet,
::letterbox). Either way the image is (B, 3, h, w) in channels_last memory,
the layout the first conv reads.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ...kernels import build
from ..device import constant_on
from ..preprocess import (LETTERBOX_PAD, device_mean_std, device_taps, letterbox,
                          letterbox_geometry, preprocess_imagenet)

OUT_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=4)
def _mean_inv_std(device: torch.device):
    """The kernel's channel tables: the f32 mean, and 1 / std in f64
    (correctly rounded), with which it computes the plain version's f32
    division by std bit for bit (csrc/preprocess.cu)."""
    mean, std = device_mean_std(device)
    return mean, torch.reciprocal(std.double())


@functools.lru_cache(maxsize=4)
def _identity(device: torch.device):
    """Mean 0 and 1 / std 1: the kernel's letterbox mode, v - 0 and
    RN32(RN64(v) * 1) = v, so the values are the plain version's bits."""
    return (constant_on(torch.zeros(3, dtype=torch.float32), device),
            constant_on(torch.ones(3, dtype=torch.float64), device))


def _frames(frame_u8: torch.Tensor, out_hw, out_dtype) -> torch.Tensor:
    """Checks the arguments -> the frames as (B, H, W, 3)."""
    if frame_u8.dtype != torch.uint8:
        raise TypeError(f"frame must be uint8, got {frame_u8.dtype}")
    if frame_u8.dim() not in (3, 4) or frame_u8.shape[-1] != 3:
        raise ValueError(f"frame must be (H, W, 3) or (B, H, W, 3), got "
                         f"{tuple(frame_u8.shape)}")
    if not frame_u8.is_contiguous():
        raise ValueError("frame must be contiguous")
    h, w = out_hw
    if not (isinstance(h, int) and isinstance(w, int) and h > 0 and w > 0):
        raise ValueError(f"out_hw must be two positive ints, got {out_hw}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    frames = frame_u8 if frame_u8.dim() == 4 else frame_u8[None]
    if min(frames.shape[:3]) == 0:
        raise ValueError(f"empty frame {tuple(frame_u8.shape)}")
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no preprocess for device {frames.device}")
    return frames


def _launch(frames, out_hw, out_dtype, channel_tables, inner_hw, pad_xy, pad_value):
    """One launch: the frames resized to ``inner_hw`` at ``pad_xy`` inside
    an ``out_hw`` image of ``pad_value``, then the channel tables' affine
    step. -> (B, 3, h, w) channels_last."""
    B, H, W, _ = frames.shape
    (h, w), (nh, nw), (pad_x, pad_y) = out_hw, inner_hw, pad_xy
    tables = (*device_taps(H, nh, frames.device), *device_taps(W, nw, frames.device),
              *channel_tables)
    out = torch.empty((B, h, w, 3), dtype=out_dtype, device=frames.device)
    with torch.cuda.device(frames.device):
        err = build.load().avp_fused_preprocess(
            frames.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tables),
            B, H, W, h, w, nh, nw, pad_y, pad_x, pad_value,
            int(out_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"avp_fused_preprocess failed: cudaError_t {err}")
    return out.permute(0, 3, 1, 2)


def fused_preprocess(frame_u8: torch.Tensor, out_hw: Tuple[int, int] = (320, 640),
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 BGR frame(s), (H, W, 3) or (B, H, W, 3), contiguous ->
    resized, RGB, ImageNet-normalised (B, 3, h, w) ``out_dtype`` in
    channels_last memory (B = 1 for a single frame).

    Counts its kernel launches in ``fused_preprocess.launches``.
    """
    frames = _frames(frame_u8, out_hw, out_dtype)
    if frames.device.type == "cpu":
        return preprocess_imagenet(frames, out_hw, out_dtype).permute(0, 3, 1, 2)
    out = _launch(frames, out_hw, out_dtype, _mean_inv_std(frames.device), out_hw, (0, 0), 0)
    fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0


def fused_letterbox(frame_u8: torch.Tensor, out_hw: Tuple[int, int] = (640, 640),
                    out_dtype: torch.dtype = torch.bfloat16):
    """The letterbox mode of the same kernel: uint8 BGR frame(s), (H, W, 3)
    or (B, H, W, 3), contiguous -> (image (B, 3, h, w) ``out_dtype`` in
    channels_last memory, scale, (pad_x, pad_y)): scaled to fit, centred
    on gray 114, RGB, [0, 1]. Every pixel, pad included, is written by the
    one launch.

    Counts its kernel launches in ``fused_letterbox.launches``.
    """
    frames = _frames(frame_u8, out_hw, out_dtype)
    hw = tuple(frames.shape[1:3])
    scale, inner_hw, pad_xy = letterbox_geometry(out_hw, hw)
    if min(inner_hw) < 1:
        raise ValueError(f"a {hw} frame letterboxes to {inner_hw} in {out_hw}")
    if frames.device.type == "cpu":
        x, scale, pad_xy = letterbox(frames, out_hw, hw, dtype=out_dtype)
        return x.permute(0, 3, 1, 2), scale, pad_xy
    out = _launch(frames, out_hw, out_dtype, _identity(frames.device), inner_hw, pad_xy,
                  LETTERBOX_PAD)
    fused_letterbox.launches += 1
    return out, scale, pad_xy


fused_letterbox.launches = 0
