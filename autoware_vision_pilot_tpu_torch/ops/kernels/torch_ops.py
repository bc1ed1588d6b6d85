"""The dispatcher operators ``torch.ops.avp.*`` of the port's kernels
(csrc/torch_ops.cpp): ``fused_preprocess``, ``fused_letterbox``,
``lane_filter_walk``, ``nms_greedy``, and the int8 kernels
``int8_quantize``, ``int8_conv_<route>`` for each route of
int8_conv.py::int8_conv_plan and ``int8_conv_d2s``.

``load()`` builds the kernels and the operator library (kernels/build.py)
on first use, loads the library into this process once and registers each
operator's fake implementation, which gives ``torch.export`` its output
shapes, types and strides (the int8 convs' outputs channels_last, as the
kernels write them) without running it. The wrappers in
preprocess_kernel.py, lane_filter_kernel.py, nms_kernel.py and
int8_conv.py call it before their CUDA launch; a program exported or
loaded on the card calls it first. A build or load that fails raises.
"""
from __future__ import annotations

import functools
from pathlib import Path

import torch

from ...kernels import build

# the operators in the order of csrc/torch_ops.cpp's call counters
OPS = ("fused_preprocess", "fused_letterbox", "lane_filter_walk", "nms_greedy",
       "int8_quantize", "int8_conv_wgmma", "int8_conv_splitk", "int8_conv_strided",
       "int8_conv_halo", "int8_conv_pointwise", "int8_conv_dot", "int8_conv_d2s")
INT8_OPS = OPS[4:]
# the int8 convs' out_kind argument: 0 f32, 1 bf16, 2 the int32 accumulators
OUT_TYPES = (torch.float32, torch.bfloat16, torch.int32)


def _nhwc_empty(like: torch.Tensor, shape, dtype) -> torch.Tensor:
    """An NCHW-shaped tensor in channels_last memory, as the int8 operators
    return their outputs."""
    return like.new_empty(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)


def _conv_out(H: int, W: int, KH: int, KW: int, geometry) -> tuple:
    ph, pw, sh, sw, dh, dw = geometry
    return ((H + 2 * ph - dh * (KH - 1) - 1) // sh + 1,
            (W + 2 * pw - dw * (KW - 1) - 1) // sw + 1)


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

    @torch.library.register_fake("avp::int8_quantize")
    def _(x, x_scale):
        return _nhwc_empty(x, x.shape, torch.int8)

    def wgmma_fake(xq, weight, w_scale, x_scale, bias, geometry, plan, out_kind):
        B, _, H, W = xq.shape
        N, _, KH, KW = weight.shape
        return _nhwc_empty(xq, (B, N, *_conv_out(H, W, KH, KW, geometry)), OUT_TYPES[out_kind])

    for route in ("wgmma", "splitk", "strided"):
        torch.library.register_fake(f"avp::int8_conv_{route}")(wgmma_fake)

    @torch.library.register_fake("avp::int8_conv_halo")
    def _(xq, weight, w_scale, x_scale, bias, pad, plan, out_kind):
        B, _, H, W = xq.shape
        N, _, KH, KW = weight.shape
        return _nhwc_empty(xq, (B, N, *_conv_out(H, W, KH, KW, (pad, pad, 1, 1, 1, 1))),
                           OUT_TYPES[out_kind])

    @torch.library.register_fake("avp::int8_conv_pointwise")
    def _(x, weight, w_scale, x_scale, x_rcp, bias, plan, out_kind):
        B, _, H, W = x.shape
        return _nhwc_empty(x, (B, weight.shape[0], H, W), OUT_TYPES[out_kind])

    @torch.library.register_fake("avp::int8_conv_dot")
    def _(x, weight, w_scale, x_scale, x_rcp, bias, lanes, out_kind):
        B, _, H, W = x.shape
        return _nhwc_empty(x, (B, weight.shape[0], H, W), OUT_TYPES[out_kind])

    @torch.library.register_fake("avp::int8_conv_d2s")
    def _(xq, weight, w_scale, x_scale, bias, plan, tma_store, out_kind):
        B, _, h, w = xq.shape
        _, O, kh, kw = weight.shape
        return _nhwc_empty(xq, (B, O, h * kh, w * kw), OUT_TYPES[out_kind])

    return build.OPS_LIBRARY


def calls() -> dict:
    """The calls of each operator in this process so far, by name, from the
    library's own counters (every caller: the wrappers, an exported program,
    a loaded AOTInductor package)."""
    import ctypes

    lib = ctypes.CDLL(str(load()))
    lib.avp_torch_op_calls.restype = ctypes.c_longlong
    return {name: int(lib.avp_torch_op_calls(i)) for i, name in enumerate(OPS)}
