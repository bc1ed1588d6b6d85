"""Quantization-aware training, the port of
autoware_vision_pilot_tpu/train/qat.py ("Quanty" QAT, the reference's
PT2E flow of Models/exports/README.md:19-55).

- weights: symmetric per-output-channel int8 fake-quant with a
  straight-through estimator, ``x + (q - x).detach()``, on the convs the
  deployment transform quantizes (export/quantize.py::quantize_for_int8_conv's
  rule: a ``Conv2d`` whose weight takes at least ``min_channels`` input
  channels per group, OIHW ``weight.shape[1]``; 1 for a depthwise conv);
  the fake-quanted weights replace the module's own for one call
  (``torch.func.functional_call``), so their gradient reaches the float
  weights;
- activations: per-tensor (or per-input-channel) fake-quant of every
  ``Conv2d`` input with at least ``min_channels`` channels, by forward
  pre-hooks (the JAX package uses flax ``intercept_methods``), each
  recording the input's amax, the observer, in a dict keyed by the conv's
  ``named_modules()`` name;
- export: ``int8_variables_from_qat`` quantizes a copy of the trained
  model with the observed scales onto the int8 kernels
  (``quantize_for_int8_conv``).

Every function has the JAX one's arithmetic, in the port's NCHW layout.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..nn.layers import Conv2d, dropout_generator


def fake_quant_ste(w, axis=None):
    """Symmetric int8 fake-quant with straight-through gradients.
    axis=None -> one per-tensor scale; axis=tuple -> amax over those dims
    (per output channel for an OIHW weight: axis=(1, 2, 3))."""
    amax = w.abs().amax() if axis is None else w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127) * scale
    return w + (q - w).detach()


def selected_convs(model: nn.Module, min_channels: int = 32) -> Dict[str, Conv2d]:
    """The convs whose weights QAT fake-quants and the export quantizes:
    float ``Conv2d`` modules with ``weight.shape[1] >= min_channels``."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, Conv2d) and m.weight.is_floating_point()
            and m.weight.shape[1] >= min_channels}


def fake_quant_params(model: nn.Module, min_channels: int = 32) -> Dict[str, torch.Tensor]:
    """{parameter name: per-output-channel fake-quanted weight} of every
    selected conv: the training-time mirror of quantize_for_int8_conv."""
    return {f"{name}.weight": fake_quant_ste(m.weight, axis=(1, 2, 3))
            for name, m in selected_convs(model, min_channels).items()}


def fake_quant_ste_static(x, scale):
    """Symmetric int8 fake-quant with a FIXED scale (a frozen observer) and
    straight-through gradients: the numerics of the deployed static-scale
    int8 conv. ``scale`` a scalar, or a (C,) vector per input channel of an
    NCHW activation."""
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    if scale.dim() == 1:
        scale = scale.reshape(1, -1, *(1,) * (x.dim() - 2))
    q = torch.clamp(torch.round(x / scale), -127, 127) * scale
    return x + (q - x).detach()


@contextlib.contextmanager
def act_quant_hooks(model: nn.Module, min_channels: int = 32,
                    static_scales: Optional[Dict[str, object]] = None,
                    per_channel: bool = False,
                    observers: Optional[Dict[str, List[torch.Tensor]]] = None):
    """Inside this block every ``Conv2d`` of ``model`` fake-quants a float
    4-D input of at least ``min_channels`` channels and appends its amax,
    max(max|x|, 1e-6) in f32 (per input channel with ``per_channel``), to
    ``observers[name]`` when a dict is given. ``static_scales`` None ->
    dynamic per-batch scales (the observer phase); {name: scale} -> frozen
    observers, the exact static scale of the deployed int8 conv (a conv
    without one passes its input unquantized)."""
    names = {m: n for n, m in model.named_modules()}

    def pre(m, args):
        x = args[0]
        if x.dim() != 4 or x.shape[1] < min_channels or not x.is_floating_point():
            return None
        xf = x.float()
        amax = torch.clamp_min(xf.abs().amax(dim=(0, 2, 3)) if per_channel
                               else xf.abs().amax(), 1e-6)
        if observers is not None:
            observers.setdefault(names[m], []).append(amax.detach())
        if static_scales is not None:
            s = static_scales.get(names[m])
            xq = xf if s is None else fake_quant_ste_static(xf, s)
        else:
            xq = fake_quant_ste(xf, axis=(0, 2, 3) if per_channel else None)
        return (xq.to(x.dtype),) + tuple(args[1:])

    handles = [m.register_forward_pre_hook(pre) for m in names if isinstance(m, Conv2d)]
    try:
        yield observers
    finally:
        for h in handles:
            h.remove()


def qat_apply(model: nn.Module, x: torch.Tensor, *, min_channels: int = 32,
              quant_acts: bool = True, static_scales: Optional[Dict[str, object]] = None,
              per_channel_act: bool = False,
              observers: Optional[Dict[str, List[torch.Tensor]]] = None):
    """``model(x)`` with QAT numerics, in the model's own mode: fake-quanted
    conv weights and (with ``quant_acts``) fake-quanted conv inputs;
    gradients flow straight through to the float weights. Pass a dict as
    ``observers`` to collect the activation amax by conv name."""
    weights = fake_quant_params(model, min_channels)
    hooks = (act_quant_hooks(model, min_channels, static_scales, per_channel_act, observers)
             if quant_acts else contextlib.nullcontext())
    with hooks:
        return functional_call(model, weights, (x,), strict=False)


def collect_act_scales(observers: Dict[str, List[torch.Tensor]]) -> Dict[str, object]:
    """{conv name: amax / 127} from the observers: per-tensor ones give
    Python floats (the largest amax over the calls), per-channel ones f32
    numpy vectors (elementwise max over the calls)."""
    scales = {}
    for name, vals in observers.items():
        arrs = [v.detach().cpu().numpy() for v in vals]
        if arrs[0].ndim == 0:
            scales[name] = max(float(a) for a in arrs) / 127.0
        else:
            amax = arrs[0]
            for a in arrs[1:]:
                amax = np.maximum(amax, a)
            scales[name] = amax / 127.0
    return scales


def int8_variables_from_qat(model: nn.Module, act_scales: Dict[str, object],
                            min_channels: int = 32) -> nn.Module:
    """A copy of the QAT-trained ``model`` in the deployment int8 format:
    every selected conv an ``Int8Conv2d`` with int8 weights, w_scale and
    the static input scale from ``act_scales`` (a vector scale folded into
    the weights), by quantize_for_int8_conv. The copy is in eval mode and
    needs no gradients; ``model`` is left as it is."""
    from ..export.quantize import quantize_for_int8_conv

    int8 = copy.deepcopy(model).eval().requires_grad_(False)
    return quantize_for_int8_conv(int8, min_channels=min_channels, act_scales=act_scales)


def distillation_kl(teacher_logits, student_logits, axis: int = 1):
    """Self-distillation term for QAT closure: KL(teacher || student) over
    the class axis (dim 1 of NCHW logits), mean over pixels, in f32; the
    teacher is detached."""
    t = teacher_logits.detach().float()
    s = student_logits.float()
    tp = torch.softmax(t, dim=axis)
    return torch.mean(torch.sum(
        tp * (torch.log_softmax(t, dim=axis) - torch.log_softmax(s, dim=axis)), dim=axis))


def make_qat_loss(model: nn.Module, base_loss: Callable, min_channels: int = 32,
                  quant_acts: bool = True, static_scales: Optional[Dict[str, object]] = None,
                  freeze_bn: bool = False, per_channel_act: bool = False):
    """``loss(x, *loss_args, generator=None) -> (base_loss(qat forward,
    *loss_args), observers)``: the forward with QAT numerics in train mode
    (its masks from ``generator``), observers by conv name.

    The reference's "advanced QAT recipes" (exports/README.md:23):
    - static_scales (collect_act_scales of an earlier observer phase)
      trains against FROZEN observers;
    - freeze_bn=True runs the forward in eval mode (BatchNorm on its
      running statistics, no updates; as in JAX, dropout and stochastic
      depth are off too), then puts the model back in its mode."""
    def loss(x, *loss_args, generator: Optional[torch.Generator] = None):
        observers: Dict[str, List[torch.Tensor]] = {}
        mode = model.training
        model.train(not freeze_bn)
        masks = (dropout_generator(generator) if generator is not None
                 else contextlib.nullcontext())
        try:
            with masks:
                out = qat_apply(model, x, min_channels=min_channels, quant_acts=quant_acts,
                                static_scales=static_scales, per_channel_act=per_channel_act,
                                observers=observers)
        finally:
            model.train(mode)
        return base_loss(out, *loss_args), observers

    return loss
