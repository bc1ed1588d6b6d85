"""Int8 post-training quantization, the port of
autoware_vision_pilot_tpu/export/quantize.py: the weight-only PTQ
(``quantize_weights_int8``, ``dequantize_weights``, ``weight_quant_error``,
``QuantizedInference``, :23-92) and the selective int8 conv path
(``quantize_variables_for_int8_conv``, :95-162, and
``calibrate_int8_activation_scales``, :165-214).

The JAX functions rewrite a variables tree; these act on the port's modules,
in the PyTorch idiom. The weight-only PTQ reads a module's parameters (the
JAX ``params``; its ``batch_stats`` are the port's buffers and stay float).
The selective path swaps every selected ``Conv2d`` for an ``Int8Conv2d``
and, with ``quantize_transpose``, every selected ``ConvTranspose2d`` for an
``Int8ConvTranspose2d``, holding the numbers the JAX tree would hold, and
calibration writes each ``input_scale``. Selection, scales and rounding are
the JAX package's, bit for bit (tests/test_torch_quantize.py,
tests/test_torch_int8_transpose.py, tests/test_torch_weight_ptq.py).
``int8_like`` readies a model to load a tree already in the int8 format,
and ``cast_quantized`` casts an int8 model's float tensors but the scales.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..nn.layers import Conv2d, ConvTranspose2d, Int8Conv2d, Int8ConvTranspose2d
from ..ops.kernels.int8_conv import f32_div


# ------------------------------------------------------------ weight-only PTQ

@torch.no_grad()
def quantize_weights_int8(model: nn.Module
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
    """Every float parameter of ``model`` -> (int8 values, scale),
    symmetric, in the parameter's own dtype: scale = max(amax, 1e-8) / 127
    and q = clip(round(p / scale), +-127). A rank-4 tensor takes one scale
    a slice of dim 0 (amax over the other dims): per output channel for a
    conv's OIHW, per input channel for a transposed conv's IOHW, as the JAX
    function's axes (0, 1, 2) of HWIO and (kh, kw, O, I) give them; any
    other tensor one scale. Other parameters pass through with a scale of
    0.0. -> ({name: q}, {name: scale})."""
    qs, scales = {}, {}
    for name, p in model.named_parameters():
        if not p.is_floating_point():
            qs[name], scales[name] = p, 0.0
            continue
        if p.dim() == 4:
            amax = p.abs().amax(dim=tuple(range(1, p.dim())), keepdim=True)
        else:
            amax = p.abs().amax()
        scale = f32_div(amax.clamp_min(1e-8), 127.0)
        # with the parameter's own strides, so that the module runs the
        # dequantized weights with the kernels it runs its own with
        qs[name] = torch.empty_like(p, dtype=torch.int8).copy_(
            torch.clamp(torch.round(p / scale), -127, 127))
        scales[name] = scale
    return qs, scales


def dequantize_weights(q_params: Mapping[str, torch.Tensor],
                       scales: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """int8 values back to f32, ``f32(q) * scale``; the rest as they are."""
    return {k: (q.float() * scales[k]).float() if q.dtype == torch.int8 else q
            for k, q in q_params.items()}


@torch.no_grad()
def weight_quant_error(model: nn.Module) -> float:
    """The largest relative error of the int8 round trip over the float
    parameters: max|p - dq| / max(max|p|, 1e-8), each in f32."""
    dq = dequantize_weights(*quantize_weights_int8(model))
    errs = [0.0]
    for k, a in model.named_parameters():
        if a.is_floating_point():
            err = (a - dq[k]).abs().amax()
            errs.append(float(err / torch.clamp_min(a.abs().amax().float(), 1e-8)))
    return max(errs)


class QuantizedInference:
    """Weight-only PTQ around a model: its parameters are kept as int8 and
    scales (quantize_weights_int8) on the model's device, and every call
    dequantizes them in ``compute_dtype`` (``q.to(cd) * scale.to(cd)``, one
    rounding) and runs the model with them in place of its own, cast to
    the input's dtype: the JAX layers compute in their input's dtype, so
    bf16-rounded weights run in f32 for an f32 input. Buffers (BatchNorm
    statistics) stay the model's. Raises on a model whose parameters lie on
    more than one device."""

    def __init__(self, model: nn.Module, compute_dtype: torch.dtype = torch.bfloat16):
        devices = {p.device for p in model.parameters()}
        if len(devices) > 1:
            raise ValueError(f"the model's parameters lie on {sorted(map(str, devices))}: "
                             "QuantizedInference keeps them on one device")
        self.model = model
        self.q_params, self.scales = quantize_weights_int8(model)
        self.compute_dtype = compute_dtype

    @property
    def nbytes(self) -> int:
        """Bytes of the stored weights: the int8 values and the scales."""
        return sum(q.numel() * q.element_size() for q in self.q_params.values()) + sum(
            s.numel() * s.element_size() for s in self.scales.values()
            if isinstance(s, torch.Tensor))

    def weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """The dequantized parameters, rounded to ``compute_dtype``, in
        ``dtype``, with the parameters' strides."""
        cd, out = self.compute_dtype, {}
        for k, q in self.q_params.items():
            if q.dtype != torch.int8:
                out[k] = q
                continue
            w = torch.empty_like(q, dtype=cd)
            torch.mul(q.to(cd), self.scales[k].to(cd), out=w)
            out[k] = w.to(dtype)
        return out

    @torch.no_grad()
    def __call__(self, x: torch.Tensor):
        tensors = {**self.weights(x.dtype), **dict(self.model.named_buffers())}
        return functional_call(self.model, tensors, (x,), strict=True)


# ------------------------------------------------------- the selective int8 path

def _int8_shell(conv: Conv2d, sx_shape: Optional[tuple]) -> Int8Conv2d:
    """An empty Int8Conv2d with ``conv``'s geometry, device and dtype, and
    an input scale of ``sx_shape`` (None: dynamic)."""
    out_ch, in_per_group, kh, kw = conv.weight.shape
    return Int8Conv2d(in_per_group * conv.groups, out_ch, (kh, kw), conv.padding,
                      conv.bias is not None, stride=conv.stride, dilation=conv.dilation,
                      groups=conv.groups, input_scale_shape=sx_shape,
                      device=conv.weight.device, dtype=conv.weight.dtype)


def _int8_from(conv: Conv2d, sx: Optional[torch.Tensor]) -> Int8Conv2d:
    """export/quantize.py:128-145 on one conv, whatever its stride,
    dilation and groups (the int8 conv keeps them)."""
    w = conv.weight.float()  # the model's own weights, bf16 or f32, in f32
    if sx is not None and sx.dim() == 1:
        # fold per-input-channel activation scales into the kernel:
        # conv(round(x / s_c), w * s_c) == conv(x, w)
        w = w * sx.reshape(1, -1, 1, 1)
    scale = f32_div(w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8), 127.0)
    wq = torch.clamp(torch.round(w / scale.reshape(-1, 1, 1, 1)), -127, 127)
    q = _int8_shell(conv, None if sx is None else tuple(sx.shape))
    q.weight.copy_(wq.to(torch.int8))
    q.weight_scale.copy_(scale)
    if sx is not None:
        q.input_scale.copy_(sx)
    if conv.bias is not None:
        q.bias.copy_(conv.bias)
    return q


def _int8_transpose_from(ct: ConvTranspose2d) -> Int8ConvTranspose2d:
    """export/quantize.py:145-156: per-output-channel scales, max over (I,
    kh, kw) of |w| in f32; no activation scale folded in."""
    w = ct.weight.float()  # (I, O, kh, kw)
    scale = f32_div(w.abs().amax(dim=(0, 2, 3)).clamp_min(1e-8), 127.0)
    wq = torch.clamp(torch.round(w / scale.reshape(1, -1, 1, 1)), -127, 127)
    in_ch, out_ch, kh, kw = ct.weight.shape
    q = Int8ConvTranspose2d(in_ch, out_ch, (kh, kw), ct.bias is not None,
                            device=w.device, dtype=ct.weight.dtype)
    q.weight.copy_(wq.to(torch.int8))
    q.weight_scale.copy_(scale)
    if ct.bias is not None:
        q.bias.copy_(ct.bias)
    return q


@torch.no_grad()
def quantize_for_int8_conv(model: nn.Module, min_channels: int = 32,
                           act_scales: Optional[Mapping[str, object]] = None,
                           quantize_transpose: bool = False) -> nn.Module:
    """Swap every ``Conv2d`` of ``model`` whose kernel takes at least
    ``min_channels`` input channels per group (the JAX rule: HWIO
    ``shape[2] >= min_channels``) for an ``Int8Conv2d``: per-output-channel
    int8 weights, w_scale = max(max|w| over (I, kh, kw), 1e-8) / 127,
    quantized from the model's own weights cast to f32.

    ``act_scales`` maps module names (``model.named_modules()``) to
    calibrated activation scales. A vector (per-input-channel) scale is
    folded into the weights before they are quantized and dequantizes with
    w_scale alone; a scalar is stored as is. Convs without one quantize
    their input dynamically until calibrated.

    ``quantize_transpose`` also swaps every ``ConvTranspose2d`` with at
    least ``min_channels`` input channels (the JAX rule: (kh, kw, O, I)
    ``shape[3] >= min_channels``) for an ``Int8ConvTranspose2d`` with
    per-output-channel scales; ``act_scales`` never apply to them (they
    quantize dynamically until calibrated), as in JAX. Each new module takes
    the mode (``training``) of the one it replaces. Returns ``model``."""
    scales = dict(act_scales or {})

    def scale_of(name, like):
        sx = scales.get(name)
        return None if sx is None else torch.as_tensor(
            sx, dtype=torch.float32, device=like.device)

    for name, m in list(model.named_modules()):
        if not (isinstance(m, (Conv2d, ConvTranspose2d)) and m.weight.is_floating_point()):
            continue
        if isinstance(m, Conv2d) and m.weight.shape[1] >= min_channels:
            q = _int8_from(m, scale_of(name, m.weight))
        elif isinstance(m, ConvTranspose2d) and quantize_transpose \
                and m.weight.shape[0] >= min_channels:
            q = _int8_transpose_from(m)
        else:
            continue
        q.train(m.training)  # a new module starts in training mode
        parent, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(parent), leaf, q)
    return model


@torch.no_grad()
def calibrate_int8_activation_scales(model: nn.Module,
                                     sample_batches: Iterable[torch.Tensor],
                                     percentile_headroom: float = 1.0
                                     ) -> nn.Module:
    """Static activation scales for every ``Int8Conv2d`` and
    ``Int8ConvTranspose2d`` of ``model`` that still has none: run ``model``
    on each batch with those modules in dynamic mode, take each one's
    running max of max(max|x|, 1e-6) over the batches, and set
    ``input_scale = amax * headroom / 127``, computed in Python float64 and
    only then rounded to f32, as the JAX function does (an f32 division
    can land one ulp away and flip quantized values). Runs on the model's
    device; the amax stays there until the end. Returns ``model``."""
    convs = [m for m in model.modules()
             if isinstance(m, (Int8Conv2d, Int8ConvTranspose2d)) and m.input_scale is None]
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


def _is_int8(leaf) -> bool:
    return getattr(leaf, "dtype", None) in (np.int8, torch.int8)


@torch.no_grad()
def int8_like(model: nn.Module, variables: Mapping) -> nn.Module:
    """``model`` made ready to load a JAX variables tree in the int8
    deployment format (``quantize_variables_for_int8_conv``'s, e.g. a QAT
    export's msgpack file): each ``Conv2d`` whose ``w`` the tree holds as
    int8 becomes an empty ``Int8Conv2d`` of its geometry, with an input
    scale of the tree's ``x_scale`` shape where it has one, and each
    ``ConvTranspose2d`` whose ``wt`` is int8 an empty
    ``Int8ConvTranspose2d``; convert/from_jax.py::variables_to_state_dict
    then fills every tensor strictly. Each new module takes the mode of the
    one it replaces. Returns ``model``."""
    from ..convert.from_jax import _flatten, _merge_digits

    flat = _flatten(variables.get("params", {}))
    for name, m in list(model.named_modules()):
        if not isinstance(m, (Conv2d, ConvTranspose2d)) or not name:
            continue
        path = _merge_digits(name)
        if not _is_int8(flat.get(f"{path}.{'w' if isinstance(m, Conv2d) else 'wt'}")):
            continue
        sx = flat.get(f"{path}.x_scale")
        sx_shape = None if sx is None else tuple(np.shape(sx))
        if isinstance(m, Conv2d):
            q = _int8_shell(m, sx_shape)
        else:
            in_ch, out_ch, kh, kw = m.weight.shape
            q = Int8ConvTranspose2d(in_ch, out_ch, (kh, kw), m.bias is not None,
                                    device=m.weight.device, dtype=m.weight.dtype)
            if sx_shape is not None:
                q.input_scale = torch.empty(sx_shape, device=m.weight.device)
        q.train(m.training)
        parent, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(parent), leaf, q)
    return model


@torch.no_grad()
def cast_quantized(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``model.to(dtype)`` for a model with int8 modules: every floating
    parameter and buffer in ``dtype`` (strides kept), but the int8 modules'
    ``weight_scale`` and ``input_scale``, which their kernels take in f32.
    The counterpart of a JAX net of that dtype over an int8 tree quantized
    from f32 weights. Returns ``model``."""
    for m in model.modules():
        keep = (("weight_scale", "input_scale")
                if isinstance(m, (Int8Conv2d, Int8ConvTranspose2d)) else ())
        for p in m.parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        for name, b in m.named_buffers(recurse=False):
            if b is not None and b.is_floating_point() and name not in keep:
                setattr(m, name, b.to(dtype))
    return model


def int8_conv_count(model: nn.Module) -> int:
    return sum(isinstance(m, Int8Conv2d) for m in model.modules())


def int8_transpose_count(model: nn.Module) -> int:
    return sum(isinstance(m, Int8ConvTranspose2d) for m in model.modules())
