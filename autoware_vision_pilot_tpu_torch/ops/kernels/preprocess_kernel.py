"""Fused frame preprocessing: the wrappers of csrc/preprocess.cu, the port of
autoware_vision_pilot_tpu/ops/pallas/preprocess_kernel.py::
fused_preprocess_pallas, and of csrc/letterbox.cu, the port of XLA's fusion
of autoware_vision_pilot_tpu/ops/preprocess.py::letterbox, with the
letterbox kernel's schedule (``letterbox_plan``, pure Python).

On a CUDA tensor each function launches its kernel through its operator
(``torch.ops.avp.fused_preprocess``, ``torch.ops.avp.fused_letterbox``:
csrc/torch_ops.cpp, which torch.export records as one node), or raises; on
a CPU tensor it runs the plain version (ops/preprocess.py::
preprocess_imagenet, ::letterbox). Either way the image is (B, 3, h, w) in channels_last memory,
the layout the first conv reads.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import torch_ops
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


def _rows_contiguous(frame_u8: torch.Tensor) -> bool:
    """Whether each (H, W, 3) frame of ``frame_u8`` is contiguous, whatever
    the stride between the frames of a batch (a crop ``frames[:, y0:]`` of
    a contiguous batch is)."""
    H, W = frame_u8.shape[-3:-1]
    want = (3 * W, 3, 1)
    return all(n == 1 or st == w
               for n, st, w in zip(frame_u8.shape[-3:], frame_u8.stride()[-3:], want))


def _frames(frame_u8: torch.Tensor, out_hw, out_dtype) -> torch.Tensor:
    """Checks the arguments -> the frames as (B, H, W, 3)."""
    if frame_u8.dtype != torch.uint8:
        raise TypeError(f"frame must be uint8, got {frame_u8.dtype}")
    if frame_u8.dim() not in (3, 4) or frame_u8.shape[-1] != 3:
        raise ValueError(f"frame must be (H, W, 3) or (B, H, W, 3), got "
                         f"{tuple(frame_u8.shape)}")
    if not _rows_contiguous(frame_u8):
        raise ValueError("each frame must be contiguous (its rows and pixels; the frames "
                         f"of a batch may be any stride apart), got strides {frame_u8.stride()}")
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


def _frame_stride(frames) -> int:
    B, H, W, _ = frames.shape
    return frames.stride(0) if B > 1 else H * W * 3


def _launch(frames, out_hw, out_dtype):
    """One launch of the ImageNet kernel. -> (B, 3, h, w) channels_last."""
    B, H, W, _ = frames.shape
    h, w = out_hw
    tables = (*device_taps(H, h, frames.device), *device_taps(W, w, frames.device),
              *_mean_inv_std(frames.device))
    torch_ops.load()
    out = torch.ops.avp.fused_preprocess(frames, *tables, h, w, out_dtype == torch.bfloat16)
    return out.permute(0, 3, 1, 2)


def fused_preprocess(frame_u8: torch.Tensor, out_hw: Tuple[int, int] = (320, 640),
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 BGR frame(s), (H, W, 3) or (B, H, W, 3), each contiguous (the
    frames of a batch any stride apart, as in a crop ``frames[:, y0:]``) ->
    resized, RGB, ImageNet-normalised (B, 3, h, w) ``out_dtype`` in
    channels_last memory (B = 1 for a single frame).

    Counts its kernel launches in ``fused_preprocess.launches`` (not the
    calls that torch.export traces).
    """
    frames = _frames(frame_u8, out_hw, out_dtype)
    if frames.device.type == "cpu":
        return preprocess_imagenet(frames, out_hw, out_dtype).permute(0, 3, 1, 2)
    out = _launch(frames, out_hw, out_dtype)
    if not torch.compiler.is_compiling():  # a trace launches nothing
        fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0


# The letterbox kernel's constants, CHUNK, WARPS, PIECE and SMEM_LIMIT in
# csrc/letterbox.cu (tests/test_torch_letterbox.py holds the two together)
LB_CHUNK = 64         # output columns a warp takes (2 a lane): its unit of work
LB_WARPS = 8          # warps a block
LB_PIECE = 64         # 16-byte words of the pad a warp writes
LB_SMEM_LIMIT = 227 * 1024


def _span(nbytes: int) -> int:
    """Shared bytes for ``nbytes`` bytes placed at any offset from 16."""
    return (nbytes + 15) // 16 * 16 + 16


def segment_pixels(px: int, W: int, nw: int) -> int:
    """The source pixels that ``px`` consecutive output columns of a W ->
    nw resize read, at most: x1[last] - x0[first] + 1 <= (px - 1) W / nw
    + 3 (csrc/letterbox.cu sizes a warp's copy of a source row by it)."""
    return min(W, -(-px * W // nw) + 3)


def letterbox_pad_runs(B: int, out_hw: Tuple[int, int], nh: int, pad_y: int, elem: int):
    """The kernel's pad: the B + 1 runs of pad rows (above image 0, between
    images b - 1 and b, below the last) of a 16-byte aligned (B, h, w, 3)
    output of ``elem``-byte values, each contiguous, cut into pieces of
    LB_PIECE 16-byte words, a warp a piece; the values before a run's
    first whole word and after its last go one by one to the warps of its
    first and last piece. -> [(first value, values, head, words, pieces)]
    for the runs with values."""
    h, w = out_hw
    below, row = h - nh - pad_y, 3 * w
    runs = []
    for r in range(B + 1):
        start = (0 if r == 0 else (r - 1) * h + pad_y + nh) * row
        n = (pad_y if r == 0 else below if r == B else below + pad_y) * row
        if n == 0:
            continue
        lead = start * elem % 16
        head = min(n, (16 - lead) // elem if lead else 0)
        words = (n - head) * elem // 16
        runs.append((start, n, head, words, max(1, -(-words // LB_PIECE))))
    return runs


class LetterboxPlan(NamedTuple):
    blocks: int        # the grid: the image units' blocks, then the pad pieces'
    image_blocks: int  # LB_WARPS warps a block, a warp a unit
    units: int         # (image row, 64 output columns) pairs: B nh chunks
    chunks: int        # units a row
    pieces: int        # pieces of the pad
    slot: int          # shared bytes of a warp's copy of one source row
    smem: int          # dynamic shared bytes of a block: two copies a warp


@functools.lru_cache(maxsize=256)
def letterbox_plan(B: int, H: int, W: int, out_hw: Tuple[int, int],
                   elem: int = 2) -> LetterboxPlan:
    """The letterbox kernel's grid for B (H, W) frames into ``out_hw``
    (``elem``-byte values): a warp for each (image row, 64 output columns),
    which copies its two source rows' bytes [3 x0[first], 3 x1[last] + 3)
    into shared memory, and then a warp for each piece of the pad
    (letterbox_pad_runs); LB_WARPS warps a block. The C entry point works
    out the same grid itself; this model is what the CPU tests replay and
    what a stage split sizes its stamp buffer by. Raises where 227 KB would
    not hold a block's copies (the kernel then refuses the launch)."""
    _, (nh, nw), (_, pad_y) = letterbox_geometry(out_hw, (H, W))
    chunks = -(-nw // LB_CHUNK)
    units = B * nh * chunks
    pieces = sum(run[4] for run in letterbox_pad_runs(B, out_hw, nh, pad_y, elem))
    slot = _span(3 * segment_pixels(LB_CHUNK, W, nw))
    smem = LB_WARPS * 2 * slot
    if smem > LB_SMEM_LIMIT:
        raise ValueError(f"a {W} -> {nw} resize does not fit the letterbox kernel's shared memory")
    image_blocks = -(-units // LB_WARPS)
    return LetterboxPlan(image_blocks + -(-pieces // LB_WARPS), image_blocks, units, chunks,
                         pieces, slot, smem)


@functools.lru_cache(maxsize=4)
def letterbox_pad_bits(out_dtype: torch.dtype, pad: int = LETTERBOX_PAD) -> int:
    """The bits of the pad value in ``out_dtype``, the one number the
    kernel stores in every pad value: RN32(pad * RN32(1/255)), as the plain
    version's f32 multiply, then (bf16) rounded to nearest even."""
    bits = int((np.float32(pad) * np.float32(1.0 / 255.0)).view(np.uint32))
    if out_dtype == torch.bfloat16:
        return (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    return bits


def _launch_letterbox(frames, out_hw, out_dtype):
    """One launch of the letterbox kernel. -> (B, 3, h, w) channels_last."""
    B, H, W, _ = frames.shape
    h, w = out_hw
    dev = frames.device
    _, (nh, nw), (pad_x, pad_y) = letterbox_geometry(out_hw, (H, W))
    tables = (*device_taps(H, nh, dev), *device_taps(W, nw, dev))
    torch_ops.load()
    out = torch.ops.avp.fused_letterbox(frames, *tables, h, w, pad_y, pad_x,
                                        letterbox_pad_bits(out_dtype), out_dtype == torch.bfloat16)
    return out.permute(0, 3, 1, 2)


def fused_letterbox(frame_u8: torch.Tensor, out_hw: Tuple[int, int] = (640, 640),
                    out_dtype: torch.dtype = torch.bfloat16):
    """The letterbox kernel: uint8 BGR frame(s), (H, W, 3) or (B, H, W, 3),
    each contiguous (the frames of a batch any stride apart) -> (image (B,
    3, h, w) ``out_dtype`` in channels_last memory, scale, (pad_x,
    pad_y)): scaled to fit, centred on gray 114, RGB, [0, 1]. Every pixel,
    pad included, is written by the one launch.

    Counts its kernel launches in ``fused_letterbox.launches`` (not the
    calls that torch.export traces).
    """
    frames = _frames(frame_u8, out_hw, out_dtype)
    hw = tuple(frames.shape[1:3])
    scale, inner_hw, pad_xy = letterbox_geometry(out_hw, hw)
    if min(inner_hw) < 1:
        raise ValueError(f"a {hw} frame letterboxes to {inner_hw} in {out_hw}")
    if frames.device.type == "cpu":
        x, scale, pad_xy = letterbox(frames, out_hw, hw, dtype=out_dtype)
        return x.permute(0, 3, 1, 2), scale, pad_xy
    out = _launch_letterbox(frames, out_hw, out_dtype)
    if not torch.compiler.is_compiling():
        fused_letterbox.launches += 1
    return out, scale, pad_xy


fused_letterbox.launches = 0
