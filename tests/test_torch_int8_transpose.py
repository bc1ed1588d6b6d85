"""The port's int8 transposed conv (nn/layers.py::Int8ConvTranspose2d over
ops/kernels/int8_conv.py::int8_conv_transpose) against the int8 branch of
the JAX package's ConvTranspose2d (nn/layers.py:187-208), and its
quantization (export/quantize.py::quantize_for_int8_conv(...,
quantize_transpose=True)) against quantize_variables_for_int8_conv. On the
CPU, where the wrapper runs its plain version.

Everything is bit-equal (rtol 0, atol 0): the int8 weights and scales (the
same f32 divisions, round half to even, clip to +-127), the quantized
input, the int32 sums (exact in any order) and the epilogue, which both
sides compute op by op: f32(acc) * (sx * w_scale), the cast, then the bias
add in the model dtype. JAX runs eagerly: under jit XLA:CPU contracts the
multiply and the add into one FMA (tests/test_torch_int8.py).
"""
import copy
import io

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from autoware_vision_pilot_tpu.export.quantize import (
    calibrate_int8_activation_scales as jax_calibrate,
    quantize_variables_for_int8_conv as jax_quantize)
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.export.quantize import (
    calibrate_int8_activation_scales, int8_conv_count, int8_transpose_count,
    quantize_for_int8_conv)
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.ops.kernels import int8_conv as k

from test_torch_layers import from_port, normal_input, seeded_variables, to_port
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def port_input(x, dtype):
    return to_port(x).to(dtype).contiguous(memory_format=torch.channels_last)


def as_f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) \
        else from_port(a.float())


def int8_variables(kh, O, C, static, seed):
    """A quantized JAX ConvTranspose2d tree: int8 (kh, kh, O, C) weights,
    per-O scales, a bias, and a static scalar x_scale or none."""
    rng = np.random.default_rng(seed)
    params = {"wt": rng.integers(-127, 128, (kh, kh, O, C)).astype(np.int8),
              "wt_scale": rng.uniform(1e-3, 2e-2, O).astype(np.float32),
              "b": rng.normal(0.0, 0.1, O).astype(np.float32)}
    if static:
        params["x_scale"] = np.float32(0.0213)
    return {"params": params}


# (kh, O, batch): windows 2 and 3, O = 3, 12 and 64, a batch of two
CASES = [(2, 3, 1), (2, 12, 2), (2, 64, 1), (3, 3, 2), (3, 12, 1), (3, 64, 2)]


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kh,O,B", CASES)
def test_int8_conv_transpose_matches_jax(kh, O, B, dtype, static):
    C, h, w = 40, 5, 7
    v = int8_variables(kh, O, C, static, seed=kh * 100 + O)
    x = normal_input((B, h, w, C), seed=O + B) * 2.0
    jmod = jl.ConvTranspose2d(O, kh, kh)
    ref = jmod.apply(v, jnp.asarray(x, JDT[dtype]))
    mod = tl.Int8ConvTranspose2d(C, O, kh, dtype=dtype)
    if static:  # ready for the tree's x_scale, as calibration leaves it
        mod.input_scale = torch.zeros(())
    mod.load_state_dict(variables_to_state_dict(v, mod), strict=True)
    y = mod(port_input(x, dtype))
    assert y.dtype == dtype and y.shape == (B, O, h * kh, w * kh)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(as_f32(y), as_f32(ref))
    if not static:  # the dynamic scale's amax, for calibration
        amax = np.maximum(np.abs(np.asarray(jnp.asarray(x, JDT[dtype]), np.float32)).max(),
                          1e-6)
        assert float(mod.observed_amax) == np.float32(amax)


def test_int32_accumulators():
    """out_dtype int32 gives JAX's int32 sums after depth to space; an int8
    input is refused (the kernel quantizes as it loads)."""
    v = int8_variables(2, 12, 48, True, seed=5)["params"]
    x = normal_input((2, 3, 4, 48), seed=6)
    xq = np.clip(np.round(x / v["x_scale"]), -127, 127).astype(np.int8)
    acc = np.einsum("bhwc,ijoc->bhwijo", xq.astype(np.int64), v["wt"].astype(np.int64))
    acc = acc.transpose(0, 1, 3, 2, 4, 5).reshape(2, 6, 8, 12)
    weight = torch.from_numpy(v["wt"]).permute(3, 2, 0, 1)
    sx = torch.tensor(v["x_scale"])
    got = k.int8_conv_transpose(port_input(x, torch.float32), weight,
                                torch.from_numpy(v["wt_scale"]), sx, None, torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(from_port(got), acc)
    with pytest.raises(TypeError):
        k.int8_conv_transpose(to_port(xq).contiguous(memory_format=torch.channels_last),
                              weight, torch.from_numpy(v["wt_scale"]), sx, None, torch.int32)


class JUp(fnn.Module):
    """tests/test_export.py::test_int8_conv_transpose_path's net."""

    @fnn.compact
    def __call__(self, x):
        h = jl.Conv2d(64, 3, padding=1, name="c")(x)
        return jl.ConvTranspose2d(32, 2, 2, name="up")(h)


class PortUp(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.c = tl.Conv2d(48, 64, 3, 1, 1, dtype=dtype)
        self.up = tl.ConvTranspose2d(64, 32, 2, dtype=dtype)

    def forward(self, x):
        return self.up(self.c(x))


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_up_net_quantized_like_jax(dtype, calibrated):
    """The Up net of tests/test_export.py: quantize_for_int8_conv(...,
    quantize_transpose=True) selects the conv and the transpose as JAX
    does, with bit-equal int8 weights and scales (quantized from the model's
    own weights, here the f32 or bf16 values), and the int8 net's output
    is JAX's bit for bit, before and after calibration."""
    x = np.random.default_rng(0).normal(0, 0.5, (1, 8, 16, 48)).astype(np.float32)
    jmod = JUp()
    v = seeded_variables(jmod, jnp.asarray(x), seed=3)
    v = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), v)
    qv = jax_quantize(v, min_channels=32, quantize_transpose=True)
    assert qv["params"]["up"]["wt"].dtype == jnp.int8
    net = PortUp(dtype)
    net.load_state_dict(variables_to_state_dict(v, net), strict=True)
    quantize_for_int8_conv(net, 32, quantize_transpose=True)
    assert (int8_conv_count(net), int8_transpose_count(net)) == (1, 1)
    assert isinstance(net.up, tl.Int8ConvTranspose2d)
    got = net.state_dict()
    want = variables_to_state_dict(qv, net)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == (torch.int8 if want[key].dtype == torch.int8
                                  else got[key].dtype), key
        np.testing.assert_array_equal(got[key].float().numpy(), want[key].numpy(),
                                      err_msg=key)
    xj = jnp.asarray(x, JDT[dtype])
    if calibrated:
        qv = jax_calibrate(jmod, qv, [xj])
        calibrate_int8_activation_scales(net, [port_input(x, dtype)])
        assert float(net.up.input_scale) == float(qv["params"]["up"]["x_scale"])
    np.testing.assert_array_equal(as_f32(net(port_input(x, dtype))),
                                  as_f32(jmod.apply(qv, xj)))


def test_min_channels_and_default_leave_transposes_float():
    net = PortUp()
    quantize_for_int8_conv(net, 32)  # quantize_transpose off: JAX's default
    assert isinstance(net.up, tl.ConvTranspose2d) and int8_transpose_count(net) == 0
    net = PortUp()
    quantize_for_int8_conv(net, 65, quantize_transpose=True)  # 64 input channels: kept
    assert int8_conv_count(net) == 0 and int8_transpose_count(net) == 0


def test_from_jax_loads_the_quantized_tree_in_the_kernel_layout():
    """An int8 ``wt`` loads strictly into the (kh, kw, O, I) buffer, and
    load_state_dict and a move keep that layout; a channels_last move
    re-lays it and the wrapper raises."""
    v = int8_variables(2, 12, 48, True, seed=9)
    mod = tl.Int8ConvTranspose2d(48, 12, 2)
    mod.input_scale = torch.zeros(())
    mod.load_state_dict(variables_to_state_dict(v, mod), strict=True)
    assert mod.weight.permute(2, 3, 1, 0).is_contiguous()
    np.testing.assert_array_equal(mod.weight.permute(2, 3, 1, 0).numpy(), v["params"]["wt"])
    np.testing.assert_array_equal(mod.weight_scale.numpy(), v["params"]["wt_scale"])
    mod = copy.deepcopy(mod)
    assert mod.weight.permute(2, 3, 1, 0).is_contiguous()
    buf = io.BytesIO()
    torch.save(mod.state_dict(), buf)
    again = tl.Int8ConvTranspose2d(48, 12, 2)
    again.input_scale = torch.zeros(())
    again.load_state_dict(torch.load(io.BytesIO(buf.getvalue())), strict=True)
    assert again.weight.permute(2, 3, 1, 0).is_contiguous()
    x = port_input(normal_input((1, 3, 4, 48)), torch.float32)
    assert torch.equal(mod(x), again(x))
    mod.to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels_last"):
        mod(x)
    with pytest.raises(ValueError):  # the wrong key set still raises
        bad = dict(v["params"], wt=np.zeros((2, 2, 12, 47), np.int8))
        mod.load_state_dict(variables_to_state_dict({"params": bad}, mod))


# the main path's transposed convs at 320x640 (h, w, C = O), k = s = 2
MAIN_TRANSPOSES = [(10, 20, 1280), (10, 20, 1456), (20, 40, 768), (40, 80, 512), (80, 160, 256)]


@pytest.mark.parametrize("h,w,C", MAIN_TRANSPOSES)
def test_plan_is_a_pointwise_plan_that_covers_the_product(h, w, C):
    """The "d2s" plan of the (M = h w, K = C) x (K, N = 4 O) product on the
    wgmma kernel: rectangles of whole rows of the h x w map, N tiles of 128
    within each of the 4 output segments, K splits that cover C."""
    plan = k.int8_conv_transpose_plan(1, h, w, C, C, 2, 2, 132)
    m_tiles, n_tiles, splits = plan.grid
    assert plan.route == "d2s" and plan.bm == plan.bn == plan.bk == k.TILE
    assert h % plan.th == 0 and plan.th * plan.tw <= k.TILE
    assert m_tiles == h // plan.th * -(-w // plan.tw) and n_tiles == 4 * -(-C // k.TILE)
    assert plan.iters == -(-C // k.TILE)
    assert (splits - 1) * plan.per_split < plan.iters <= splits * plan.per_split
    assert plan.blocks == min(m_tiles * n_tiles * splits, 132)


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        k.int8_conv_transpose_plan(1, 10, 20, 1450, 1450, 2, 2)  # C not a multiple of 16
    with pytest.raises(ValueError):
        k.int8_conv_transpose_plan(1, 0, 20, 256, 256, 2, 2)


def test_wrapper_checks_its_arguments():
    v = int8_variables(2, 12, 48, True, seed=2)["params"]
    weight = torch.from_numpy(v["wt"]).permute(3, 2, 0, 1)
    ws = torch.from_numpy(v["wt_scale"])
    x = port_input(normal_input((1, 3, 4, 48)), torch.float32)
    with pytest.raises(ValueError, match="scalar"):
        k.int8_conv_transpose(x, weight, ws, torch.ones(48), None)
    with pytest.raises(TypeError):
        k.int8_conv_transpose(x, weight, ws, torch.tensor(0.1), torch.zeros(12, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="channels"):
        k.int8_conv_transpose(port_input(normal_input((1, 3, 4, 40)), torch.float32), weight,
                              ws, torch.tensor(0.1))
    with pytest.raises(ValueError):  # an OIHW-contiguous weight is not the kernel's layout
        k.int8_conv_transpose(x, weight.contiguous(), ws, torch.tensor(0.1))
