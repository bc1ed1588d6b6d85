"""Per-frame post-processing, the port of the main path's functions in
autoware_vision_pilot_tpu/ops/postprocess.py. NHWC in, JAX layouts out."""
from __future__ import annotations

import torch


def argmax_mask(logits_nhwc):
    """(B,H,W,C) logits -> (B,H,W) int32 class ids; ties take the first
    index, as jnp.argmax does."""
    return torch.argmax(logits_nhwc, dim=-1).to(torch.int32)


def threshold_channels(logits_nhwc, threshold: float = 0.0):
    """EgoLanes per-channel binary masks (value > thr -> 1.0)."""
    return (logits_nhwc > threshold).to(torch.float32)


def depth_minmax_scale(depth_nhw1):
    """Scale relative depth to [0,1] per frame."""
    lo = depth_nhw1.amin(dim=(-3, -2, -1), keepdim=True)
    hi = depth_nhw1.amax(dim=(-3, -2, -1), keepdim=True)
    return (depth_nhw1 - lo) / (hi - lo).clamp_min(1e-9)
