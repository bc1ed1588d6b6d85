"""Int8 convolution: the wrappers of csrc/int8_conv.cu, the port of the int8
branch of autoware_vision_pilot_tpu/nn/layers.py::Conv2d (:81-113), which
the JAX package leaves to XLA.

Two kernels, each with its wrapper, its plain PyTorch version and its count
of launches:

- ``int8_quantize``: xq = clip(round_half_even(f32(x) / sx), -127, 127),
  sx a scalar or one scale per input channel (nn/layers.py:103-108).
- ``int8_conv``: the int32 accumulators of conv(xq, w), then
  ``cast(f32(acc) * dequant) + bias`` with dequant = sx * w_scale for a
  scalar sx, w_scale alone for a per-channel one, which the weights carry
  (:110-113); or the accumulators themselves for ``out_dtype=torch.int32``.

``int8_conv2d`` chains the two. On a CUDA tensor a wrapper launches its
kernel or raises; on a CPU tensor it runs the plain version, which computes
the conv in float64 on the int8 values (exact: |acc| <= 127^2 * K < 2^53)
and the same epilogue in torch ops. Every scale is an f32 tensor on the
input's device, so no launch waits for the host.

The kernels cover what the selective-int8 path needs: groups 1, stride 1,
dilation 1, any window with symmetric padding, NHWC (channels_last) inputs
and (O, kh, kw, I) weights, i.e. OIHW weights in channels_last memory.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...kernels import build

CL = torch.channels_last
IN_DTYPES = (torch.float32, torch.bfloat16)
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def f32_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once, on every device: torch divides a CUDA tensor by
    a Python number as a * (1 / b), which can differ by an ulp."""
    return a / torch.full_like(a, b)


def dynamic_input_scale(x: torch.Tensor):
    """The dynamic per-tensor scale of nn/layers.py:99-101 -> (sx, amax),
    both f32 0-dim tensors on x's device: amax = max(max|x|, 1e-6),
    sx = amax / 127."""
    amax = x.abs().amax().float().clamp_min(1e-6)
    return f32_div(amax, 127.0), amax


def _pad(padding) -> int:
    ph, pw = (padding, padding) if isinstance(padding, int) else tuple(padding)
    if ph != pw or ph < 0:
        raise ValueError(f"int8 conv needs one symmetric padding, got {padding}")
    return ph


def _check_nhwc(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what} must be 4-D NCHW, got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=CL):
        raise ValueError(f"{what} must be channels_last contiguous")


def _check_scale(x_scale: torch.Tensor, cin: int, device) -> None:
    if x_scale.dtype != torch.float32 or x_scale.device != device:
        raise TypeError(f"x_scale must be f32 on {device}, got "
                        f"{x_scale.dtype} on {x_scale.device}")
    if x_scale.shape not in ((), (cin,)):
        raise ValueError(f"x_scale must be () or ({cin},), got "
                         f"{tuple(x_scale.shape)}")


def int8_quantize_plain(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    s = x_scale.reshape(1, -1, 1, 1) if x_scale.dim() == 1 else x_scale
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q.contiguous(memory_format=CL)


def int8_quantize(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) f32/bf16 channels_last -> int8 channels_last.
    Counts its kernel launches in ``int8_quantize.launches``."""
    if x.dtype not in IN_DTYPES:
        raise TypeError(f"x must be one of {IN_DTYPES}, got {x.dtype}")
    _check_nhwc(x, "x")
    _check_scale(x_scale, x.shape[1], x.device)
    if x.device.type == "cpu":
        return int8_quantize_plain(x, x_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 quantize for device {x.device}")
    B, C, H, W = x.shape
    xq = torch.empty_like(x, dtype=torch.int8, memory_format=CL)
    scale = x_scale.contiguous()
    with torch.cuda.device(x.device):
        err = build.load().avp_int8_quantize(
            x.data_ptr(), xq.data_ptr(), scale.data_ptr(),
            int(x_scale.dim() == 1), B * H * W, C, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"avp_int8_quantize failed: cudaError_t {err}")
    int8_quantize.launches += 1
    return xq


int8_quantize.launches = 0


def int8_conv_plain(xq: torch.Tensor, weight: torch.Tensor,
                    weight_scale: torch.Tensor, x_scale: torch.Tensor,
                    bias: Optional[torch.Tensor], padding,
                    out_dtype: torch.dtype) -> torch.Tensor:
    acc = F.conv2d(xq.double(), weight.double(), None, 1, padding)
    # the float64 sums are exact integers; round() only guards against an
    # algorithm that transforms its inputs (FFT, Winograd)
    acc = acc.round().to(torch.int32).contiguous(memory_format=CL)
    if out_dtype == torch.int32:
        return acc
    dequant = weight_scale if x_scale.dim() == 1 else x_scale * weight_scale
    y = (acc.float() * dequant.reshape(1, -1, 1, 1)).to(out_dtype)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y.contiguous(memory_format=CL)


def int8_conv(xq: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
              x_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
              padding=0, out_dtype: torch.dtype = torch.bfloat16, *, stride=1,
              groups: int = 1, dilation=1) -> torch.Tensor:
    """int8 (B, C, H, W) channels_last, int8 OIHW channels_last weights ->
    (B, O, OH, OW) channels_last in ``out_dtype`` (f32, bf16, or int32 for
    the raw accumulators). ``x_scale`` is the scale xq was made with.
    Counts its kernel launches in ``int8_conv.launches``."""
    if xq.dtype != torch.int8 or weight.dtype != torch.int8:
        raise TypeError(f"xq and weight must be int8, got {xq.dtype}, {weight.dtype}")
    if groups != 1 or stride not in (1, (1, 1)) or dilation not in (1, (1, 1)):
        raise ValueError(f"int8 conv covers groups 1, stride 1, dilation 1; got "
                         f"groups={groups} stride={stride} dilation={dilation}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"out_dtype must be one of {tuple(_OUT_KIND)}, got {out_dtype}")
    _check_nhwc(xq, "xq")
    _check_nhwc(weight, "weight")
    pad = _pad(padding)
    B, C, H, W = xq.shape
    N, _, KH, KW = weight.shape
    if weight.shape[1] != C:
        raise ValueError(f"weight {tuple(weight.shape)} does not take {C} channels")
    if weight_scale.dtype != torch.float32 or weight_scale.shape != (N,):
        raise TypeError(f"weight_scale must be f32 ({N},), got "
                        f"{weight_scale.dtype} {tuple(weight_scale.shape)}")
    _check_scale(x_scale, C, xq.device)
    if bias is not None and out_dtype != torch.int32 and (
            bias.dtype != out_dtype or bias.shape != (N,)):
        raise TypeError(f"bias must be {out_dtype} ({N},), got {bias.dtype} "
                        f"{tuple(bias.shape)}")
    if any(t.device != xq.device for t in (weight, weight_scale)):
        raise ValueError("xq, weight and scales must be on one device")
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, weight, weight_scale, x_scale, bias, pad,
                               out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no int8 conv for device {xq.device}")
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    if OH <= 0 or OW <= 0:
        raise ValueError(f"window {KH}x{KW} larger than the padded input {H}x{W}")
    if C % 16:  # the kernel copies 16 channels at a time; zeros add nothing
        extra = 16 - C % 16
        xq = F.pad(xq, (0, 0, 0, 0, 0, extra)).contiguous(memory_format=CL)
        weight = F.pad(weight, (0, 0, 0, 0, 0, extra)).contiguous(memory_format=CL)
        C += extra
    if xq.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("xq and weight must be 16-byte aligned")
    out = torch.empty((B, OH, OW, N), dtype=out_dtype, device=xq.device)
    x_ptr = x_scale.data_ptr() if x_scale.dim() == 0 else None
    b_ptr = bias.data_ptr() if bias is not None and out_dtype != torch.int32 else None
    with torch.cuda.device(xq.device):
        err = build.load().avp_int8_conv(
            xq.data_ptr(), weight.data_ptr(), weight_scale.data_ptr(), x_ptr,
            b_ptr, out.data_ptr(), B, H, W, C, N, KH, KW, pad,
            _OUT_KIND[out_dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"avp_int8_conv failed: cudaError_t {err}")
    int8_conv.launches += 1
    return out.permute(0, 3, 1, 2)


int8_conv.launches = 0


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
                x_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                padding=0, *, plain: bool = False) -> torch.Tensor:
    """The whole int8 conv of nn/layers.py:81-113 on a float input, in the
    input's dtype: quantize, then conv with the dequant epilogue.
    ``plain=True`` runs the plain versions on any device (a reference run
    selects it explicitly; the kernels never fall back to it)."""
    if plain:
        xq = int8_quantize_plain(x, x_scale)
        return int8_conv_plain(xq, weight, weight_scale, x_scale, bias,
                               _pad(padding), x.dtype)
    return int8_conv(int8_quantize(x, x_scale), weight, weight_scale, x_scale,
                     bias, padding, x.dtype)
