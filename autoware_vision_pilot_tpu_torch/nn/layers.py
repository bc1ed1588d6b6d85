"""Layer library of the PyTorch port, with the numerics of
autoware_vision_pilot_tpu/nn/layers.py and of the flax BatchNorm and
Dropout that the JAX networks use.

Modules take and return NCHW tensors; the pipeline keeps them in
``torch.channels_last``, so each is the same NHWC buffer as in the JAX
package. Parameter names are torch's own (``weight``, ``bias``,
``running_mean``, ``running_var``), so a model's ``state_dict()`` has the
reference's torch key layout, the one convert/torch_import.py reads.

Parameters are allocated uninitialised; ``init_seeded`` fills a module tree
from an explicit ``torch.Generator``.

Train mode follows ``Module.training``, as in torch: BatchNorm2d normalizes
with the batch statistics and updates its running ones, Dropout and
stochastic depth (``drop_rows``) draw masks. A module starts in training
mode, so every serving entry point calls ``.eval()``. A train-mode forward
draws its masks inside ``dropout_generator(generator)``, the counterpart of
flax's ``rngs={"dropout": key}``, and raises outside it.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.int8_conv import dynamic_input_scale, int8_conv2d, int8_conv_transpose
from ..parallel.sharding import batch_shard

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention, running = (1 - m) running + m batch: flax's 0.9

_MASK_GENERATOR = contextvars.ContextVar("mask_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator):
    """The generator that train-mode Dropout and stochastic depth draw their
    masks from inside this block."""
    token = _MASK_GENERATOR.set(generator)
    try:
        yield generator
    finally:
        _MASK_GENERATOR.reset(token)


def keep_mask(shape, keep_prob: float, device) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``, each value True with
    probability ``keep_prob`` (uniform < p, as ``jax.random.bernoulli``),
    drawn on the device of the enclosing ``dropout_generator``'s generator.
    Inside ``parallel.sharding.batch_sharded`` dim 0 is this rank's rows of
    a batch split over W ranks: the whole batch's mask is drawn, the same
    on every rank, and the rank keeps its rows."""
    shard = batch_shard()
    if shard is None:
        return draw_keep_mask(shape, keep_prob, device)
    n = shape[0]
    whole = draw_keep_mask((shard.world * n, *shape[1:]), keep_prob, device)
    return whole[shard.rank * n:(shard.rank + 1) * n]


def draw_keep_mask(shape, keep_prob: float, device) -> torch.Tensor:
    generator = _MASK_GENERATOR.get()
    if generator is None:
        raise RuntimeError("a train-mode forward draws its dropout masks inside "
                           "nn.layers.dropout_generator(generator)")
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < keep_prob).to(device)


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
    Conv2d modules for these, with the conv's own padding, ``stride``,
    ``dilation`` and ``groups`` (JAX passes them to its int8
    ``lax.conv_general_dilated`` as to the float one, nn/layers.py:73-79).

    Without ``input_scale`` the scale is dynamic, max(max|x|, 1e-6) / 127,
    kept on the device; each call then records the running ``observed_amax``
    that calibration reads. ``plain = True`` routes a module through the
    kernels' plain versions, for a reference run that asks for it.
    """

    def __init__(self, in_ch, out_ch, kernel_size=3, padding=0, bias=True, *,
                 stride=1, dilation=1, groups=1, input_scale_shape=None, device=None,
                 dtype=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.padding = _pair(padding)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty((out_ch, in_ch // groups, kh, kw), device=device, dtype=torch.int8,
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
            if not torch.compiler.is_compiling():  # a trace keeps no fake tensor here
                self.observed_amax = (amax if self.observed_amax is None
                                      else torch.maximum(self.observed_amax, amax))
        return int8_conv2d(x, self.weight, self.weight_scale, sx, self.bias,
                           self.padding, stride=self.stride, dilation=self.dilation,
                           groups=self.groups, plain=self.plain)


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


class Int8ConvTranspose2d(nn.Module):
    """The int8 branch of the JAX package's ConvTranspose2d (nn/layers.py:
    187-208) for kernel == stride and padding 0: xq = quantize(x, sx), one
    int8 product over the input channels with depth to space
    (ops/kernels/int8_conv.py::int8_conv_transpose), then ``cast(f32(acc) *
    (sx * w_scale)) + bias`` in the model dtype.

    A class of its own beside ConvTranspose2d, as Int8Conv2d is beside
    Conv2d. ``weight`` is int8 of torch's (in, out, kh, kw) shape, the one
    ``state_dict`` and convert/from_jax.py use, over a (kh, kw, out, in)
    buffer (a permuted view): the kernel's (kh kw out, in) weights with
    the input channels contiguous. ``load_state_dict`` and ``Module.to``
    without a memory format keep that layout; ``Module.to(memory_format=
    torch.channels_last)`` re-lays it, and the kernel's wrapper then
    raises. ``weight_scale`` is f32 per output channel (the JAX
    ``wt_scale``), ``input_scale`` the static scalar (the JAX ``x_scale``)
    that calibration sets; until then the scale is dynamic, max(max|x|,
    1e-6) / 127, kept on the device, and each call records the running
    ``observed_amax`` that calibration reads. ``plain = True`` routes a
    module through the kernel's plain version.
    """

    def __init__(self, in_ch, out_ch, kernel_size=2, bias=True, *, device=None, dtype=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = (kh, kw)
        buf = torch.empty((kh, kw, out_ch, in_ch), device=device, dtype=torch.int8)
        self.weight = nn.Parameter(buf.permute(3, 2, 0, 1), requires_grad=False)
        self.register_buffer(
            "weight_scale", torch.empty(out_ch, device=device, dtype=torch.float32))
        self.register_buffer("input_scale", None)
        self.register_parameter(
            "bias", _param((out_ch,), device, dtype) if bias else None)
        self.observed_amax = None
        self.plain = False

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last)
        sx = self.input_scale
        if sx is None:
            sx, amax = dynamic_input_scale(x)
            if not torch.compiler.is_compiling():  # a trace keeps no fake tensor here
                self.observed_amax = (amax if self.observed_amax is None
                                      else torch.maximum(self.observed_amax, amax))
        return int8_conv_transpose(x, self.weight, self.weight_scale, sx, self.bias,
                                   plain=self.plain)


class Linear(nn.Module):
    def __init__(self, in_features, out_features, *, device=None, dtype=None):
        super().__init__()
        self.weight = _param((out_features, in_features), device, dtype)
        self.bias = _param((out_features,), device, dtype)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class BatchNorm2d(nn.Module):
    """BatchNorm over channels (dim 1). ``eps`` is torch's default; the YOLO
    family uses 1e-3 (models/yolo_layers.py).

    At eval it normalizes with the running statistics. In train mode, as
    flax's BatchNorm: with the batch mean and biased variance over (N, H,
    W), and the running statistics become ``(1 - momentum) running +
    momentum batch``, the variance the biased one too (torch's own
    ``F.batch_norm`` would fold in the unbiased one). ``momentum`` is 1 -
    flax's: 0.1 for the B0 trunks, 0.03 for the YOLO family, 0.01 for the
    Lite ConvBNReLU (flax's default). The batch statistics
    come from the fused kernel's saved mean and 1/sqrt(var + eps), in f32
    for a bf16 input."""

    def __init__(self, num_features, *, eps=BN_EPS, momentum=BN_MOMENTUM, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = _param((num_features,), device, dtype)
        self.bias = _param((num_features,), device, dtype)
        self.register_buffer(
            "running_mean", torch.empty(num_features, device=device, dtype=dtype))
        self.register_buffer(
            "running_var", torch.empty(num_features, device=device, dtype=dtype))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        shard = batch_shard()
        if shard is not None:
            y, mean, var = _SyncedBatchNorm.apply(x, self.weight, self.bias, self.eps, shard)
            self._update_running(mean, var)
            return y
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                  True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.double().pow(-2).sub_(self.eps)
        self._update_running(mean, var)
        return y

    @torch.no_grad()
    def _update_running(self, mean, var):
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
        self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)


class _SyncedBatchNorm(torch.autograd.Function):
    """Train-mode batch norm of one rank's rows with the statistics of the
    whole batch, as JAX's SPMD BatchNorm computes them over a sharded
    batch: each rank's count, mean and sum of squared deviations (f32) go
    into its row of a (W, 2C + 1) f64 buffer, one all-reduce gathers the
    rows, and the ranks' statistics are combined (Chan et al.) into the
    mean and biased variance of all the rows, the same on every rank. The
    backward all-reduces the two per-channel sums that the input's gradient
    takes over the whole batch; the weight's and bias's gradients are this
    rank's parts (the train step averages the gradients over the ranks).
    -> (y, mean, var), the statistics f64."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, shard):
        xf = x.float()
        c = x.shape[1]
        n = xf.numel() // c
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        rows = torch.zeros((shard.world, 2 * c + 1), dtype=torch.float64, device=x.device)
        rows[shard.rank, 0] = n
        rows[shard.rank, 1:c + 1] = mean
        rows[shard.rank, c + 1:] = var.double() * n
        torch.distributed.all_reduce(rows, group=shard.group)
        counts, means, m2 = rows[:, :1], rows[:, 1:c + 1], rows[:, c + 1:]
        total = counts.sum()
        g_mean = (counts * means).sum(0) / total
        g_var = (m2 + counts * (means - g_mean) ** 2).sum(0) / total
        mean32, invstd = g_mean.float(), torch.rsqrt(g_var + eps).float()
        xhat = (xf - mean32[:, None, None]) * invstd[:, None, None]
        y = xhat * weight.float()[:, None, None] + bias.float()[:, None, None]
        ctx.save_for_backward(x, weight, mean32, invstd)
        ctx.total, ctx.group = float(total), shard.group
        ctx.mark_non_differentiable(g_mean, g_var)
        return y.to(x.dtype), g_mean, g_var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        g = dy.float()
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        local = torch.stack([g.sum((0, 2, 3)), (g * xhat).sum((0, 2, 3))])
        whole = local.clone()
        torch.distributed.all_reduce(whole, group=ctx.group)
        dx = (weight.float() * invstd)[:, None, None] * (
            g - whole[0][:, None, None] / ctx.total - xhat * (whole[1][:, None, None] / ctx.total))
        return (dx.to(x.dtype), local[1].to(weight.dtype), local[0].to(weight.dtype),
                None, None)


class Dropout(nn.Module):
    """flax's Dropout: in train mode each value is kept with probability
    1 - rate and scaled by 1 / (1 - rate), the rest set to 0; the
    identity at eval. The mask of an NCHW map is drawn in the JAX
    package's NHWC order, (B, H, W, C), and permuted."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if x.dim() == 4:
            b, c, h, w = x.shape
            mask = keep_mask((b, h, w, c), keep, x.device).permute(0, 3, 1, 2)
        else:
            mask = keep_mask(x.shape, keep, x.device)
        return torch.where(mask, x / keep, 0.0)


def drop_rows(h, rate: float, training: bool):
    """Stochastic depth in row mode (the JAX package's MBConv): in train
    mode each sample's residual branch is kept with probability 1 - rate,
    ``h * keep / (1 - rate)``; the identity otherwise."""
    if not training or rate <= 0.0:
        return h
    keep = keep_mask((h.shape[0],) + (1,) * (h.dim() - 1), 1.0 - rate, h.device)
    return h * keep / (1.0 - rate)


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
