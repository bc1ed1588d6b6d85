"""The lane-filter window walk: the wrapper of csrc/lane_filter.cu, the port's
counterpart of XLA's fusion of the JAX package's start-point scan and
window-walk ``lax.scan``s (autoware_vision_pilot_tpu/perception/
lane_filter.py:80-199, ``_find_start`` and both ``direction_scan``s).

On a CUDA tensor it launches the kernel, a thread-block cluster of 8 blocks,
or raises; on a CPU tensor it runs the plain version,
perception/lane_filter.py::lane_filter_walk_plain.
"""
from __future__ import annotations

import torch

from ...kernels import build

# what fits the kernel's shared memory: each of its 8 blocks stages an
# eighth of the mask, the two walking blocks hold the mask as two bitmasks,
# and every block the four walks' logs, a step per 4 rows
MAX_PIXELS = 320 * 320
MAX_ROWS = 4096


def lane_filter_walk(masks: torch.Tensor):
    """(H, W, 3) f32 contiguous masks [ego_left, ego_right, other] ->
    (weights (2, H, W) int32, starts (2, 3) int32 [x, y, found]), left
    then right: each side's start point and the sum of its up and down
    walks' weight images.

    Counts its kernel launches in ``lane_filter_walk.launches``.
    """
    if masks.dtype != torch.float32:
        raise TypeError(f"masks must be float32, got {masks.dtype}")
    if masks.dim() != 3 or masks.shape[-1] != 3:
        raise ValueError(f"masks must be (H, W, 3), got {tuple(masks.shape)}")
    if not masks.is_contiguous():
        raise ValueError("masks must be contiguous")
    H, W, _ = masks.shape
    if H < 1 or W < 1:
        raise ValueError(f"empty masks {tuple(masks.shape)}")

    if masks.device.type == "cpu":
        from ...perception.lane_filter import lane_filter_walk_plain
        return lane_filter_walk_plain(masks)
    if masks.device.type != "cuda":
        raise ValueError(f"no lane-filter walk for device {masks.device}")
    if H * W > MAX_PIXELS or H > MAX_ROWS:
        raise ValueError(f"{H}x{W} masks: the kernel takes at most {MAX_PIXELS} pixels "
                         f"and {MAX_ROWS} rows")

    return _launch(masks)


def _launch(masks: torch.Tensor, stamps: torch.Tensor | None = None):
    """One launch of the kernel on checked CUDA masks. ``stamps``, a (16,)
    int64 CUDA tensor, receives each side's %globaltimer at its stages (see
    csrc/lane_filter.cu); the path passes none."""
    H, W, _ = masks.shape
    weights = torch.empty((2, H, W), dtype=torch.int32, device=masks.device)
    starts = torch.empty((2, 3), dtype=torch.int32, device=masks.device)
    with torch.cuda.device(masks.device):
        err = build.load().avp_lane_filter_walk(
            masks.data_ptr(), weights.data_ptr(), starts.data_ptr(), H, W,
            None if stamps is None else stamps.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"avp_lane_filter_walk failed: cudaError_t {err}")
    lane_filter_walk.launches += 1
    return weights, starts


lane_filter_walk.launches = 0
