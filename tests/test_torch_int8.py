"""The port's int8 conv (nn/layers.py::Int8Conv2d, ops/kernels/int8_conv.py)
against the int8 branch of the JAX package's Conv2d (nn/layers.py:81-113).
On the CPU, where the wrappers run the kernels' plain versions. The slice
as a whole is test_torch_int8_slice.py's.

Tolerances: the layer in f32 is bit-equal (rtol 0, atol 0) to the JAX
layer run op by op, and its int32 accumulators equal numpy's int64
arithmetic; in bf16, from the same bf16 input, at most one bf16 ulp. The
layer is held against JAX's eager apply, which rounds the dequant product
and the bias add separately, as nn/layers.py:112-121 is written and as the
kernel does; under jit, XLA:CPU contracts the two into one FMA and lands
one f32 ulp away on some outputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from autoware_vision_pilot_tpu.export.quantize import (
    quantize_variables_for_int8_conv as jax_quantize)
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
    dynamic_input_scale, int8_conv, int8_quantize)

from test_torch_layers import from_port, normal_input, seeded_variables, to_port

CL = torch.channels_last


def bf16_ulps(a, b):
    """max |a - b| in units of the bf16 spacing at b."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -133))) - 7)
    return float(np.max(np.abs(a - b) / ulp))


def conv_int64(xq_nhwc, w_hwio, pad):
    """The int8 conv's accumulators in numpy int64 arithmetic."""
    k = w_hwio.shape[0]
    xp = np.pad(xq_nhwc.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    win = sliding_window_view(xp, (k, k), axis=(1, 2))  # (B, OH, OW, C, kh, kw)
    B, OH, OW = win.shape[:3]
    cols = win.transpose(0, 1, 2, 4, 5, 3).reshape(B * OH * OW, -1)
    return (cols @ w_hwio.astype(np.int64).reshape(-1, w_hwio.shape[-1])
            ).reshape(B, OH, OW, -1)


def scale_for(kind, x):
    """A calibration-like static scale: amax / 127 in float64, then f32,
    times 0.9 for the scalar so that some values clip."""
    if kind == "scalar":
        return np.float32(float(np.abs(x).max()) * 0.9 / 127.0)
    if kind == "vector":
        return (np.abs(x).max(axis=(0, 1, 2)).astype(np.float64) / 127.0
                ).astype(np.float32)
    return None


@pytest.mark.parametrize("scale", ["dynamic", "scalar", "vector"])
@pytest.mark.parametrize("hw", [(1, 1), (8, 16)])
@pytest.mark.parametrize("cout", [20, 64])
@pytest.mark.parametrize("cin", [256, 288, 1456])
@pytest.mark.parametrize("k", [1, 3])
def test_int8_conv_layer_matches_jax(k, cin, cout, hw, scale):
    seed = k * 7 + cin + cout + hw[0]
    x = normal_input((1, *hw, cin), seed=seed) * np.linspace(
        0.5, 2.0, cin, dtype=np.float32)  # channels of unequal range
    jmod = jl.Conv2d(cout, k, 1, k // 2)
    sx = scale_for(scale, x)
    qv = jax_quantize(seeded_variables(jmod, x, seed=seed + 1), 256,
                      act_scales=None if sx is None else {(): sx})
    apply = jmod.apply  # op by op: two roundings, see the module docstring

    def port(dtype):
        m = tl.Int8Conv2d(cin, cout, k, k // 2, dtype=dtype,
                          input_scale_shape=None if sx is None else sx.shape)
        m.load_state_dict(variables_to_state_dict(qv, m), strict=True)
        return m

    # f32: bit-equal
    m32 = port(torch.float32)
    xt = to_port(x)
    np.testing.assert_array_equal(from_port(m32(xt)), np.asarray(apply(qv, x)))
    if sx is None:
        assert m32.observed_amax.item() == np.float32(np.abs(x).max())

    # the quantized input and the int32 accumulators against numpy
    s = torch.from_numpy(np.asarray(sx)) if sx is not None else dynamic_input_scale(xt)[0]
    xq = int8_quantize(xt, s)
    want_q = np.clip(np.round(x / (s.numpy() if s.dim() else s.item())), -127, 127)
    np.testing.assert_array_equal(from_port(xq), want_q.astype(np.int8))
    acc = int8_conv(xq, m32.weight, m32.weight_scale, s, None, k // 2, torch.int32)
    np.testing.assert_array_equal(from_port(acc),
                                  conv_int64(from_port(xq), np.asarray(qv["params"]["w"]),
                                             k // 2))

    # bf16: the same bf16 input to both, at most one bf16 ulp
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(apply(qv, xb).astype(jnp.float32))
    got = port(torch.bfloat16)(to_port(np.asarray(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(from_port(got.float()), ref) <= 1.0


def test_int8_wrappers_reject_what_the_kernels_do_not_take():
    x = to_port(normal_input((1, 4, 5, 32), seed=1))
    s = torch.tensor(0.02)
    w = torch.zeros(8, 32, 3, 3, dtype=torch.int8).contiguous(memory_format=CL)
    ws = torch.ones(8)
    xq = int8_quantize(x, s)
    with pytest.raises(ValueError, match="channels_last"):
        int8_quantize(x.contiguous(), s)
    with pytest.raises(ValueError, match="channels_last"):
        int8_conv(xq.contiguous(), w, ws, s, None, 1)
    with pytest.raises(ValueError, match="groups"):
        int8_conv(xq, w, ws, s, None, 1, groups=2)
    with pytest.raises(ValueError, match="stride"):
        int8_conv(xq, w, ws, s, None, 1, stride=2)
    with pytest.raises(TypeError, match="x_scale"):
        int8_quantize(x, s.double())
    with pytest.raises(ValueError, match="x_scale"):
        int8_quantize(x, torch.ones(3))
    with pytest.raises(TypeError, match="bias"):
        int8_conv(xq, w, ws, s, torch.zeros(8, dtype=torch.bfloat16), 1, torch.float32)
    with pytest.raises(ValueError, match="symmetric"):
        int8_conv(xq, w, ws, s, None, (1, 0))


def test_dynamic_mode_keeps_a_running_amax():
    m = tl.Int8Conv2d(16, 4, 1)
    m.weight.zero_()
    m.weight_scale.fill_(1.0)
    m.bias.zero_()
    for peak in (3.0, 7.5, 5.0):
        x = torch.zeros(1, 16, 2, 2).contiguous(memory_format=CL)
        x[0, 3, 1, 1] = -peak
        m(x)
    assert m.observed_amax.item() == 7.5
    m(torch.zeros(1, 16, 2, 2))  # the 1e-6 floor, and an NCHW input is accepted
    assert m.observed_amax.item() == 7.5
