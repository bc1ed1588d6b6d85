"""Layer library of the PyTorch port, eval-mode, with the numerics of
autoware_vision_pilot_tpu/nn/layers.py.

Modules take and return NCHW tensors; the pipeline keeps them in
``torch.channels_last``, so each is the same NHWC buffer as in the JAX
package. Parameter names are torch's own (``weight``, ``bias``,
``running_mean``, ``running_var``), so a model's ``state_dict()`` has the
reference's torch key layout, the one convert/torch_import.py reads.

Parameters are allocated uninitialised; ``init_seeded`` fills a module tree
from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.int8_conv import dynamic_input_scale, int8_conv2d

BN_EPS = 1e-5


def gelu(x):
    """Exact (erf) GELU in float32 and the tanh approximation in bfloat16,
    as the JAX package chooses per dtype."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


silu = F.silu


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Conv2d(nn.Module):
    """torch Conv2d semantics: symmetric padding, groups, dilation."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=0,
                 groups=1, bias=True, dilation=1, *, device=None, dtype=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.weight = _param((out_ch, in_ch // groups, kh, kw), device, dtype)
        self.register_parameter(
            "bias", _param((out_ch,), device, dtype) if bias else None)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class Int8Conv2d(nn.Module):
    """The int8 branch of the JAX package's Conv2d (nn/layers.py:81-113):
    int8 x int8 -> int32 on the card's tensor cores (ops/kernels/int8_conv.py),
    then ``cast(f32(acc) * dequant) + bias`` in the model dtype.

    A class of its own beside Conv2d, not a branch of it: its state differs
    (``weight`` int8 OIHW in channels_last memory, f32 ``weight_scale``, the
    JAX ``w_scale``, per output channel, and the optional f32 ``input_scale``,
    the JAX ``x_scale``: () or (in_ch,) when per-input-channel scales were
    folded into the weights), so ``isinstance`` tells which convs run int8
    and Conv2d's forward stays free of branches. export/quantize.py swaps
    Conv2d modules for these; it covers stride 1, groups 1, dilation 1.

    Without ``input_scale`` the scale is dynamic, max(max|x|, 1e-6) / 127,
    kept on the device; each call then records the running ``observed_amax``
    that calibration reads. ``plain = True`` routes a module through the
    kernels' plain versions, for a reference run that asks for it.
    """

    def __init__(self, in_ch, out_ch, kernel_size=3, padding=0, bias=True, *,
                 input_scale_shape=None, device=None, dtype=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.padding = _pair(padding)
        self.weight = nn.Parameter(
            torch.empty((out_ch, in_ch, kh, kw), device=device, dtype=torch.int8,
                        memory_format=torch.channels_last), requires_grad=False)
        self.register_buffer(
            "weight_scale", torch.empty(out_ch, device=device, dtype=torch.float32))
        self.register_buffer(
            "input_scale", None if input_scale_shape is None else
            torch.empty(input_scale_shape, device=device, dtype=torch.float32))
        self.register_parameter(
            "bias", _param((out_ch,), device, dtype) if bias else None)
        self.observed_amax = None
        self.plain = False

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last)
        sx = self.input_scale
        if sx is None:
            sx, amax = dynamic_input_scale(x)
            self.observed_amax = (amax if self.observed_amax is None
                                  else torch.maximum(self.observed_amax, amax))
        return int8_conv2d(x, self.weight, self.weight_scale, sx, self.bias,
                           self.padding, plain=self.plain)


class ConvTranspose2d(nn.Module):
    """Transposed conv for the kernel == stride, padding 0 case (the U-neck
    and head upsamples). Weight layout (in, out, kh, kw), as torch's."""

    def __init__(self, in_ch, out_ch, kernel_size=2, *, device=None,
                 dtype=None):
        super().__init__()
        self.stride = _pair(kernel_size)
        self.weight = _param((in_ch, out_ch, *self.stride), device, dtype)
        self.bias = _param((out_ch,), device, dtype)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride)


class Linear(nn.Module):
    def __init__(self, in_features, out_features, *, device=None, dtype=None):
        super().__init__()
        self.weight = _param((out_features, in_features), device, dtype)
        self.bias = _param((out_features,), device, dtype)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class BatchNorm2d(nn.Module):
    """Eval-mode BatchNorm over channels (dim 1) with running statistics.
    ``eps`` is torch's default; the YOLO family uses 1e-3
    (models/yolo_layers.py)."""

    def __init__(self, num_features, *, eps=BN_EPS, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = _param((num_features,), device, dtype)
        self.bias = _param((num_features,), device, dtype)
        self.register_buffer(
            "running_mean", torch.empty(num_features, device=device, dtype=dtype))
        self.register_buffer(
            "running_var", torch.empty(num_features, device=device, dtype=dtype))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class Conv1dCenter(nn.Module):
    """torch Conv1d(in_ch, out_ch, 3, 1, 1) applied to a length-1 sequence:
    both neighbours of the one input are zero padding, so only the centre
    tap sees data and the conv is a product with ``weight[:, :, 1]``. The
    full (out, in, 3) weight is kept, as the reference's checkpoints hold
    it. Takes (B, in_ch) -> (B, out_ch)."""

    def __init__(self, in_ch, out_ch, *, device=None, dtype=None):
        super().__init__()
        self.weight = _param((out_ch, in_ch, 3), device, dtype)
        self.bias = _param((out_ch,), device, dtype)

    def forward(self, y):
        return F.linear(y, self.weight[:, :, 1], self.bias)


def max_pool2d(x, kernel: int, stride: int | None = None, padding: int = 0):
    """torch nn.MaxPool2d semantics (padding counts as -inf)."""
    return F.max_pool2d(x, kernel, stride or kernel, padding)


def upsample2x_nearest(x):
    """torch nn.Upsample(scale_factor=2) (mode 'nearest'): each pixel
    repeated 2x2, in the memory format of ``x``."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


@torch.no_grad()
def init_seeded(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every layer of ``module`` from ``generator``, a CPU generator,
    so that one seed gives the same weights on every device and dtype.

    Weights are normal with std sqrt(2 / fan_in), where fan_in counts the
    inputs summed into one output (for the k == s transposed conv, its
    input channels; for ``Conv1dCenter``, the in_ch of its centre tap),
    so activations keep their scale through the random
    network; biases are normal with std 0.1. BatchNorm gets non-trivial
    affine terms and running statistics, as tests/support/torch_b0.py's
    ``randomize_bn_stats`` gives the reference's.
    """
    def fill(t, draw):
        cpu = torch.empty(t.shape, dtype=torch.float32)
        draw(cpu)
        t.copy_(cpu)

    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear, Conv1dCenter)):
            fan_in = (m.weight.shape[0] if isinstance(m, ConvTranspose2d)
                      else m.weight.shape[1] if isinstance(m, Conv1dCenter)
                      else m.weight[0].numel())
            std = (2.0 / fan_in) ** 0.5
            fill(m.weight, lambda t: t.normal_(0.0, std, generator=generator))
            if m.bias is not None:
                fill(m.bias, lambda t: t.normal_(0.0, 0.1, generator=generator))
        elif isinstance(m, BatchNorm2d):
            fill(m.running_mean,
                 lambda t: t.normal_(0.0, 0.5, generator=generator))
            fill(m.running_var,
                 lambda t: t.uniform_(0.5, 1.5, generator=generator))
            fill(m.weight, lambda t: t.normal_(1.0, 0.2, generator=generator))
            fill(m.bias, lambda t: t.normal_(0.0, 0.2, generator=generator))
    return module
