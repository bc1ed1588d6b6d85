"""The dispatcher operators ``torch.ops.avp.*`` of the four kernels on the
exported steps (csrc/torch_ops.cpp): ``fused_preprocess``,
``fused_letterbox``, ``lane_filter_walk`` and ``nms_greedy``.

``load()`` builds the kernels and the operator library (kernels/build.py)
on first use, loads the library into this process once and registers each
operator's fake implementation, which gives ``torch.export`` its output
shapes and types without running it. The wrappers in preprocess_kernel.py,
lane_filter_kernel.py and nms_kernel.py call it before their CUDA launch;
a program exported or loaded on the card calls it first. A build or load
that fails raises.
"""
from __future__ import annotations

import functools
from pathlib import Path

import torch

from ...kernels import build

# the operators in the order of csrc/torch_ops.cpp's call counters
OPS = ("fused_preprocess", "fused_letterbox", "lane_filter_walk", "nms_greedy")


@functools.cache
def load() -> Path:
    """Build if needed, load the operator library once per process and
    register the fake implementations. -> the library's path."""
    build.build()
    torch.ops.load_library(str(build.OPS_LIBRARY))

    @torch.library.register_fake("avp::fused_preprocess")
    def _(frames, y0, y1, fy, x0, x1, fx, mean, inv_std, h, w, out_bf16):
        return frames.new_empty((frames.shape[0], h, w, 3),
                                dtype=torch.bfloat16 if out_bf16 else torch.float32)

    @torch.library.register_fake("avp::fused_letterbox")
    def _(frames, y0, y1, fy, x0, x1, fx, h, w, pad_y, pad_x, pad_bits, out_bf16):
        return frames.new_empty((frames.shape[0], h, w, 3),
                                dtype=torch.bfloat16 if out_bf16 else torch.float32)

    @torch.library.register_fake("avp::lane_filter_walk")
    def _(masks, stamps=None):
        n, h, w, _ = masks.shape
        return (masks.new_empty((n, 2, h, w), dtype=torch.int32),
                masks.new_empty((n, 2, 3), dtype=torch.int32))

    @torch.library.register_fake("avp::nms_greedy")
    def _(boxes, scores, classes, max_det, iou_thresh, conf_thresh, class_aware, cluster,
          stamps=None):
        n = scores.shape[0]
        return (boxes.new_empty((n, max_det, 4)), boxes.new_empty((n, max_det)),
                boxes.new_empty((n, max_det), dtype=torch.int32),
                boxes.new_empty((n, max_det), dtype=torch.bool))

    return build.OPS_LIBRARY


def calls() -> dict:
    """The calls of each operator in this process so far, by name, from the
    library's own counters (every caller: the wrappers, an exported program,
    a loaded AOTInductor package)."""
    import ctypes

    lib = ctypes.CDLL(str(load()))
    lib.avp_torch_op_calls.restype = ctypes.c_longlong
    return {name: int(lib.avp_torch_op_calls(i)) for i, name in enumerate(OPS)}
