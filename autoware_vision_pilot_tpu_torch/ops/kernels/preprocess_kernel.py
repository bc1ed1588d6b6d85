"""Fused frame preprocessing: the wrapper of csrc/preprocess.cu, the port of
autoware_vision_pilot_tpu/ops/pallas/preprocess_kernel.py::
fused_preprocess_pallas.

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it runs
the plain version, ops/preprocess.py::preprocess_imagenet. Either way the
result is (B, 3, h, w) in channels_last memory, the layout the first conv
reads.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ...kernels import build
from ..preprocess import device_mean_std, device_taps, preprocess_imagenet

OUT_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=4)
def _mean_inv_std(device: torch.device):
    """The kernel's channel tables: the f32 mean, and 1 / std in f64
    (correctly rounded), with which it computes the plain version's f32
    division by std bit for bit (csrc/preprocess.cu)."""
    mean, std = device_mean_std(device)
    return mean, torch.reciprocal(std.double())


def fused_preprocess(frame_u8: torch.Tensor, out_hw: Tuple[int, int] = (320, 640),
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 BGR frame(s), (H, W, 3) or (B, H, W, 3), contiguous ->
    resized, RGB, ImageNet-normalised (B, 3, h, w) ``out_dtype`` in
    channels_last memory (B = 1 for a single frame).

    Counts its kernel launches in ``fused_preprocess.launches``.
    """
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
    B, H, W, _ = frames.shape
    if min(B, H, W) == 0:
        raise ValueError(f"empty frame {tuple(frame_u8.shape)}")

    if frames.device.type == "cpu":
        return preprocess_imagenet(frames, (h, w), out_dtype).permute(0, 3, 1, 2)
    if frames.device.type != "cuda":
        raise ValueError(f"no preprocess for device {frames.device}")

    tables = (*device_taps(H, h, frames.device), *device_taps(W, w, frames.device),
              *_mean_inv_std(frames.device))
    out = torch.empty((B, h, w, 3), dtype=out_dtype, device=frames.device)
    with torch.cuda.device(frames.device):
        err = build.load().avp_fused_preprocess(
            frames.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tables),
            B, H, W, h, w, int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"avp_fused_preprocess failed: cudaError_t {err}")
    fused_preprocess.launches += 1
    return out.permute(0, 3, 1, 2)


fused_preprocess.launches = 0
