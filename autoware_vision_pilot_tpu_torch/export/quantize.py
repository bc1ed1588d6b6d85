"""Selective int8 post-training quantization, the port of
autoware_vision_pilot_tpu/export/quantize.py::quantize_variables_for_int8_conv
(:95-162) and ::calibrate_int8_activation_scales (:165-214).

The JAX functions rewrite a variables tree; these act on the port's modules
in place, in the PyTorch idiom: every selected ``Conv2d`` is swapped for an
``Int8Conv2d`` holding the same numbers the JAX tree would hold, and
calibration writes each ``input_scale``. Selection, scales and rounding are
the JAX package's, bit for bit (tests/test_torch_quantize.py).

Not ported yet: ``quantize_transpose`` (the int8 ConvTranspose2d branch),
``quantize_weights_int8``/``QuantizedInference``.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Optional

import torch
from torch import nn

from ..nn.layers import Conv2d, Int8Conv2d
from ..ops.kernels.int8_conv import f32_div


def _int8_from(conv: Conv2d, sx: Optional[torch.Tensor]) -> Int8Conv2d:
    if conv.groups != 1 or conv.stride != (1, 1) or conv.dilation != (1, 1):
        raise NotImplementedError(
            "the int8 conv covers groups 1, stride 1, dilation 1; got "
            f"groups={conv.groups} stride={conv.stride} dilation={conv.dilation}")
    w = conv.weight.float()  # the model's own weights, bf16 or f32, in f32
    if sx is not None and sx.dim() == 1:
        # fold per-input-channel activation scales into the kernel:
        # conv(round(x / s_c), w * s_c) == conv(x, w)
        w = w * sx.reshape(1, -1, 1, 1)
    scale = f32_div(w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8), 127.0)
    wq = torch.clamp(torch.round(w / scale.reshape(-1, 1, 1, 1)), -127, 127)
    out_ch, in_ch, kh, kw = conv.weight.shape
    q = Int8Conv2d(in_ch, out_ch, (kh, kw), conv.padding, conv.bias is not None,
                   input_scale_shape=None if sx is None else tuple(sx.shape),
                   device=w.device, dtype=conv.weight.dtype)
    q.weight.copy_(wq.to(torch.int8))
    q.weight_scale.copy_(scale)
    if sx is not None:
        q.input_scale.copy_(sx)
    if conv.bias is not None:
        q.bias.copy_(conv.bias)
    return q


@torch.no_grad()
def quantize_for_int8_conv(model: nn.Module, min_channels: int = 32,
                           act_scales: Optional[Mapping[str, object]] = None
                           ) -> nn.Module:
    """Swap every ``Conv2d`` of ``model`` whose kernel takes at least
    ``min_channels`` input channels per group (the JAX rule: HWIO
    ``shape[2] >= min_channels``) for an ``Int8Conv2d``: per-output-channel
    int8 weights, w_scale = max(max|w| over (I, kh, kw), 1e-8) / 127,
    quantized from the model's own weights cast to f32.

    ``act_scales`` maps module names (``model.named_modules()``) to
    calibrated activation scales. A vector (per-input-channel) scale is
    folded into the weights before they are quantized and dequantizes with
    w_scale alone; a scalar is stored as is. Convs without one quantize
    their input dynamically until calibrated. Returns ``model``.
    """
    scales = dict(act_scales or {})

    def scale_of(name, like):
        sx = scales.get(name)
        return None if sx is None else torch.as_tensor(
            sx, dtype=torch.float32, device=like.device)

    def selected(m):
        return isinstance(m, Conv2d) and m.weight.is_floating_point() \
            and m.weight.shape[1] >= min_channels

    for name, m in list(model.named_modules()):
        if selected(m):
            parent, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(parent), leaf,
                    _int8_from(m, scale_of(name, m.weight)))
    return model


@torch.no_grad()
def calibrate_int8_activation_scales(model: nn.Module,
                                     sample_batches: Iterable[torch.Tensor],
                                     percentile_headroom: float = 1.0
                                     ) -> nn.Module:
    """Static activation scales for every ``Int8Conv2d`` of ``model`` that
    still has none: run ``model`` on each batch with those convs in dynamic
    mode, take each conv's running max of max(max|x|, 1e-6) over the
    batches, and set ``input_scale = amax * headroom / 127``, computed in
    Python float64 and only then rounded to f32, as the JAX function does
    (an f32 division can land one ulp away and flip quantized values).
    Runs on the model's device; the amax stays there until the end.
    Returns ``model``."""
    convs = [m for m in model.modules()
             if isinstance(m, Int8Conv2d) and m.input_scale is None]
    for m in convs:
        m.observed_amax = None
    for x in sample_batches:
        model(x)
    for m in convs:
        if m.observed_amax is None:  # not on the path: stays dynamic
            continue
        amax = float(m.observed_amax)
        m.input_scale = torch.tensor(amax * percentile_headroom / 127.0,
                                     dtype=torch.float32, device=m.weight.device)
        m.observed_amax = None
    return model


def int8_conv_count(model: nn.Module) -> int:
    return sum(isinstance(m, Int8Conv2d) for m in model.modules())
