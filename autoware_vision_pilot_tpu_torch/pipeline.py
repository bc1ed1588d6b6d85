"""The main perception path, the port of bench.py::build_pipeline_fused:
fused-preprocess kernel -> SharedPerceptionStack (SceneSeg + Scene3D on one
B0 trunk) -> EgoLanesNetwork -> post-processing, one frame per call.

With ``int8=True`` it is bench.py's default deployment: every Conv2d with at
least ``min_ch`` input channels runs int8 x int8 -> int32 with calibrated
static scales (72 convs per frame at min_ch 256: 41 in the stack, 31 in
EgoLanes), through the int8 quantize and conv kernels.

Outputs keep the JAX package's layouts: the class mask (B, h, w) int32,
depth scaled to [0, 1] (B, h, w, 1) f32 and the lane masks
(B, h/4, w/4, 3) f32.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .export.quantize import calibrate_int8_activation_scales, quantize_for_int8_conv
from .models.ego_lanes import EgoLanesNetwork
from .models.multitask import SharedPerceptionStack
from .nn.layers import init_seeded
from .ops.kernels.preprocess_kernel import fused_preprocess
from .ops.postprocess import argmax_mask, depth_minmax_scale, threshold_channels


class FusedPipeline:
    def __init__(self, stack: SharedPerceptionStack, lanes: EgoLanesNetwork,
                 out_hw: Tuple[int, int], dtype: torch.dtype):
        self.stack = stack
        self.lanes = lanes
        self.out_hw = tuple(out_hw)
        self.dtype = dtype

    @torch.inference_mode()
    def logits(self, frame_u8: torch.Tensor):
        """uint8 BGR frame(s) (H, W, 3) or (B, H, W, 3) on the pipeline's
        device -> NHWC (seg logits, depth, lane logits) in the model dtype."""
        x = fused_preprocess(frame_u8, self.out_hw, self.dtype)
        seg, depth, _ = self.stack(x)
        lanes = self.lanes(x)
        return tuple(t.permute(0, 2, 3, 1) for t in (seg, depth, lanes))

    @torch.inference_mode()
    def __call__(self, frame_u8: torch.Tensor):
        """-> (mask (B,h,w) int32, depth01 (B,h,w,1) f32,
        lane_masks (B,h/4,w/4,3) f32)."""
        seg, depth, lanes = self.logits(frame_u8)
        return (argmax_mask(seg.float()), depth_minmax_scale(depth.float()),
                threshold_channels(lanes.float()))


def calibration_batches(out_hw: Tuple[int, int], dtype: torch.dtype, device,
                        n: int = 4):
    """bench.py:34-37: ``n`` batches of N(0, 1) noise of the network input's
    shape from ``np.random.default_rng(7)``, in the model dtype, as NCHW
    channels_last views of NHWC buffers on ``device``."""
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.normal(0.0, 1.0, (1, *out_hw, 3)))
            .float().to(device=device, dtype=dtype).permute(0, 3, 1, 2)
            for _ in range(n)]


def build_pipeline_fused(device, dtype=torch.bfloat16, seed: int = 0,
                         ctx_hw: Tuple[int, int] = (10, 20),
                         out_hw: Tuple[int, int] = (320, 640), *,
                         int8: bool = False, min_ch: int = 256) -> FusedPipeline:
    """Both networks at full width and depth with weights drawn from
    ``seed`` on the CPU (the same weights on every device), then moved to
    ``device`` in ``dtype`` and channels_last. ``ctx_hw`` is ``out_hw``/32.

    ``int8=True``, as bench.py::build_pipeline_fused(int8=True, min_ch):
    after the cast, each network's convs with >= ``min_ch`` input channels
    are quantized from its ``dtype`` weights and calibrated on
    ``calibration_batches`` on ``device``, through the kernels in dynamic
    mode."""
    generator = torch.Generator().manual_seed(seed)
    kw = dict(device="cpu", dtype=torch.float32)
    stack = SharedPerceptionStack(ctx_hw, with_domain=False, **kw)
    lanes = EgoLanesNetwork(ctx_hw, **kw)
    for m in (stack, lanes):
        init_seeded(m, generator)
        m.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        m.eval()
        if int8:
            quantize_for_int8_conv(m, min_ch)
            calibrate_int8_activation_scales(
                m, calibration_batches(out_hw, dtype, device))
    return FusedPipeline(stack, lanes, out_hw, dtype)
