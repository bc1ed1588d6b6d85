"""The lane-filter window walk: the wrapper of csrc/lane_filter.cu, the port's
counterpart of XLA's fusion of the JAX package's start-point scan and
window-walk ``lax.scan``s (autoware_vision_pilot_tpu/perception/
lane_filter.py:80-199, ``_find_start`` and both ``direction_scan``s).

On a CUDA tensor it launches the kernel through its operator
``torch.ops.avp.lane_filter_walk`` (csrc/torch_ops.cpp), a thread-block
cluster of 8 blocks for each stream of a batch, or raises; on a CPU tensor
it runs the plain version, perception/lane_filter.py::lane_filter_walk_plain.
"""
from __future__ import annotations

import torch

from . import torch_ops

# what fits the kernel's shared memory: each of its 8 blocks stages an
# eighth of the mask, the two walking blocks hold the mask as two bitmasks,
# and every block the four walks' logs, a step per 4 rows
MAX_PIXELS = 320 * 320
MAX_ROWS = 4096


MAX_STREAMS = 65535  # the grid's y extent


def lane_filter_walk(masks: torch.Tensor):
    """(H, W, 3) or (N, H, W, 3) f32 contiguous masks [ego_left, ego_right,
    other], a stream each -> (weights (..., 2, H, W) int32, starts (..., 2,
    3) int32 [x, y, found]), left then right: each side's start point and
    the sum of its up and down walks' weight images. A batch is one launch,
    a cluster a stream, and every stream's result is the one a call on it
    alone gives.

    Counts its kernel launches in ``lane_filter_walk.launches`` (not the
    calls that torch.export traces).
    """
    if masks.dtype != torch.float32:
        raise TypeError(f"masks must be float32, got {masks.dtype}")
    if masks.dim() not in (3, 4) or masks.shape[-1] != 3:
        raise ValueError(f"masks must be (H, W, 3) or (N, H, W, 3), got {tuple(masks.shape)}")
    if not masks.is_contiguous():
        raise ValueError("masks must be contiguous")
    H, W = masks.shape[-3:-1]
    if H < 1 or W < 1 or masks.numel() == 0:
        raise ValueError(f"empty masks {tuple(masks.shape)}")

    if masks.device.type == "cpu":
        from ...perception.lane_filter import lane_filter_walk_plain
        return lane_filter_walk_plain(masks)
    if masks.device.type != "cuda":
        raise ValueError(f"no lane-filter walk for device {masks.device}")
    if H * W > MAX_PIXELS or H > MAX_ROWS:
        raise ValueError(f"{H}x{W} masks: the kernel takes at most {MAX_PIXELS} pixels "
                         f"and {MAX_ROWS} rows")
    if masks.dim() == 4 and masks.shape[0] > MAX_STREAMS:
        raise ValueError(f"{masks.shape[0]} streams: the kernel takes at most {MAX_STREAMS}")

    return _launch(masks)


def _launch(masks: torch.Tensor, stamps: torch.Tensor | None = None):
    """One launch of the kernel on checked CUDA masks, (H, W, 3) or (N, H,
    W, 3). ``stamps``, a (16,) int64 CUDA tensor, receives stream 0's
    walking blocks' %globaltimer at their stages (see csrc/lane_filter.cu);
    the path passes none."""
    torch_ops.load()
    weights, starts = torch.ops.avp.lane_filter_walk(masks if masks.dim() == 4 else masks[None],
                                                     stamps)
    if not torch.compiler.is_compiling():  # a trace launches nothing
        lane_filter_walk.launches += 1
    return (weights, starts) if masks.dim() == 4 else (weights[0], starts[0])


lane_filter_walk.launches = 0
