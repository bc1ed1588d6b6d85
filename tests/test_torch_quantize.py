"""The port's selective-int8 quantization and calibration
(autoware_vision_pilot_tpu_torch/export/quantize.py) against the JAX
package's quantize_variables_for_int8_conv and
calibrate_int8_activation_scales, and the weight bridge for quantized
trees. On the CPU; the port's int8 convs run the kernels' plain versions.

Weights, scales and selection must be bit-equal (rtol 0, atol 0): both
sides do the same f32 divisions, round half to even and clip to +-127 from
the same weights. Calibrated scales are bit-equal where the int8 convs see
bit-equal inputs, and behind a float B0 trunk when they are fed JAX's
activations; computing their own, they agree to a few f32 ulps.
"""
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
from autoware_vision_pilot_tpu.models import efficientnet as je
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.export.quantize import (
    calibrate_int8_activation_scales, int8_conv_count, quantize_for_int8_conv)
from autoware_vision_pilot_tpu_torch.models import efficientnet as te
from autoware_vision_pilot_tpu_torch.nn import layers as tl

from test_torch_layers import (from_port, jax_int8_calls, normal_input, port_int8_calls,
                               port_with, seeded_variables, to_port)
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)


class JNet(fnn.Module):
    """48 -> 64 (3x3) -> 288 (1x1) -> 20 (3x3): convs with 48, 64 and 288
    input channels, so min_channels 32 selects all three and 256 one."""

    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(jl.Conv2d(64, 3, 1, 1, name="c1")(x))
        h = fnn.relu(jl.Conv2d(288, 1, name="c2")(h))
        return jl.Conv2d(20, 3, 1, 1, name="c3")(h)


class PortNet(nn.Module):
    def __init__(self, dtype=None):
        super().__init__()
        self.c1 = tl.Conv2d(48, 64, 3, 1, 1, dtype=dtype)
        self.c2 = tl.Conv2d(64, 288, 1, dtype=dtype)
        self.c3 = tl.Conv2d(288, 20, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        h = torch.relu(self.c1(x))
        return self.c3(torch.relu(self.c2(h)))


X = normal_input((1, 8, 16, 48), seed=30)


def act_scales(kind):
    """Calibration-like scales for c1 and c3, by JAX path and port name."""
    rng = np.random.default_rng(31)
    if kind == "none":
        return None, None
    if kind == "scalar":
        s = {"c1": 0.0371, "c3": 0.0123}
    else:
        s = {"c1": rng.uniform(0.01, 0.05, 48).astype(np.float32),
             "c3": rng.uniform(0.001, 0.02, 288).astype(np.float32)}
    return {(k,): v for k, v in s.items()}, s


def cast_tree(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scales", ["none", "scalar", "vector"])
@pytest.mark.parametrize("min_channels", [32, 256])
def test_quantize_matches_jax_bit_for_bit(min_channels, scales, dtype):
    v = seeded_variables(JNet(), X, seed=32)
    if dtype == torch.bfloat16:  # bench quantizes bf16 (param_dtype) weights
        v = cast_tree(v, jnp.bfloat16)
    jax_scales, port_scales = act_scales(scales)
    qv = jax_quantize(v, min_channels, act_scales=jax_scales)

    port = port_with(PortNet(dtype), v)
    quantize_for_int8_conv(port, min_channels, act_scales=port_scales)
    selected = {n for n, m in port.named_modules() if isinstance(m, tl.Int8Conv2d)}
    assert selected == {n for n, leaf in qv["params"].items()
                        if leaf["w"].dtype == jnp.int8}
    assert selected == ({"c1", "c2", "c3"} if min_channels == 32 else {"c3"})

    # the bridge carries JAX's quantized tree into the port's quantized
    # modules strictly; every tensor must then equal the port's own
    got = port.state_dict()
    want = variables_to_state_dict(qv, port)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k].to(want[k].dtype), want[k]), k
        if k.endswith(("weight_scale", "input_scale")):
            assert got[k].dtype == torch.float32
    for name in selected:
        m = port.get_submodule(name)
        assert m.weight.dtype == torch.int8 and m.weight.abs().max() <= 127
        assert m.weight.is_contiguous(memory_format=torch.channels_last)
        has_scale = port_scales is not None and name in port_scales
        assert (m.input_scale is not None) == has_scale


def test_quantize_leaves_small_and_depthwise_convs_float():
    trunk = tl.init_seeded(te.EfficientNetB0Features(te.B0_DRYRUN_STAGES),
                           torch.Generator().manual_seed(0))
    quantize_for_int8_conv(trunk, 32)
    for m in trunk.modules():
        if isinstance(m, tl.Conv2d):  # the stem, depthwise and narrow convs
            assert m.weight.shape[1] < 32
    assert int8_conv_count(trunk) == 13


def test_quantize_refuses_what_the_int8_kernel_does_not_cover():
    """The conv this test once saw refused (3x3 stride 2, 64 -> 8): the
    int8 conv now takes JAX's whole rule, so it is quantized as JAX
    quantizes it and, in f32, computes JAX's int8 branch."""
    jmod = jl.Conv2d(8, 3, 2, 1)
    x = normal_input((1, 9, 14, 64), seed=40)
    v = seeded_variables(jmod, x, seed=41)
    qv = jax_quantize(v, 32)
    port = port_with(nn.Sequential(tl.Conv2d(64, 8, 3, stride=2, padding=1)),
                     {"params": {"0": v["params"]}})
    quantize_for_int8_conv(port, 32)
    q = port[0]
    assert isinstance(q, tl.Int8Conv2d) and q.stride == (2, 2) and q.padding == (1, 1)
    want = variables_to_state_dict({"params": {"0": qv["params"]}}, port)
    for k, t in port.state_dict().items():
        assert torch.equal(t, want[k]), k
    with torch.no_grad():
        got = from_port(port(to_port(x)))
    np.testing.assert_allclose(got, np.asarray(jmod.apply(qv, x)), atol=2e-4, rtol=1e-3)


def calibrate_both(jmod, port, batches, min_channels):
    v = seeded_variables(jmod, batches[0], seed=33)
    qv = jax_quantize(v, min_channels)
    sv = jax_calibrate(jmod, qv, [jnp.asarray(b) for b in batches])
    port_with(port, v)
    quantize_for_int8_conv(port, min_channels)
    calibrate_int8_activation_scales(port, [to_port(b) for b in batches])
    return sv, port


def test_calibration_matches_jax_small_net():
    """tests/test_export.py's calibration net, two batches."""
    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            h = fnn.relu(jl.Conv2d(64, 3, 1, 1, name="c1")(x))
            return jl.Conv2d(32, 3, 1, 1, name="c2")(h)

    class Port(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = tl.Conv2d(48, 64, 3, 1, 1)
            self.c2 = tl.Conv2d(64, 32, 3, 1, 1)

        def forward(self, x):
            return self.c2(torch.relu(self.c1(x)))

    batches = [normal_input((1, 16, 32, 48), seed=s) for s in (34, 35)]
    batches[1] *= 1.5
    sv, port = calibrate_both(Net(), Port(), batches, 32)
    for name in ("c1", "c2"):
        want = np.asarray(sv["params"][name]["x_scale"])
        got = port.get_submodule(name).input_scale.numpy()
        assert want.dtype == got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # static-scale outputs: bit-equal in f32
    x = normal_input((1, 16, 32, 48), seed=36)
    np.testing.assert_array_equal(from_port(port(to_port(x))),
                                  np.asarray(Net().apply(sv, x)))


def test_calibration_matches_jax_b0_dryrun_trunk():
    """A B0_DRYRUN trunk at min_channels 32: 13 int8 convs (SE squeezes,
    expand and project 1x1s, the head), each behind float convs, BatchNorm
    and SiLU. Fed the activations JAX's int8 convs saw (forward pre-hooks),
    the port's calibration gives JAX's scales bit for bit. Left to compute
    its own activations, it lands a few f32 ulps away: the float layers'
    last bits differ between XLA and PyTorch (f32 summation order and
    formulas, ~1e-7 relative) and the max over a map moves with them
    (measured: at most 4 ulps, most 1-2)."""
    x = [normal_input((1, 32, 64, 3), seed=s) for s in (37, 38)]
    jmod = je.EfficientNetB0Features(stages=je.B0_DRYRUN_STAGES)
    sv, port = calibrate_both(jmod, te.EfficientNetB0Features(te.B0_DRYRUN_STAGES), x, 32)
    want = variables_to_state_dict(sv, port)
    scales = {k: v for k, v in port.state_dict().items() if k.endswith("input_scale")}
    assert len(scales) == int8_conv_count(port) == 13
    ulps = {k: float(np.max(np.abs(v.numpy() - want[k].numpy())
                            / np.spacing(want[k].numpy()))) for k, v in scales.items()}
    assert max(ulps.values()) <= 8, ulps

    v = seeded_variables(jmod, x[0], seed=33)
    jax_inputs = [c[1] for b in x for c in jax_int8_calls(jmod, jax_quantize(v, 32), b)[1]]
    forced = quantize_for_int8_conv(
        port_with(te.EfficientNetB0Features(te.B0_DRYRUN_STAGES), v), 32)
    calls, remove = port_int8_calls([forced], jax_inputs)
    try:
        calibrate_int8_activation_scales(forced, [to_port(b) for b in x])
    finally:
        remove()
    assert len(calls) == len(jax_inputs) == 2 * 13
    for k, t in forced.state_dict().items():
        if k.endswith("input_scale"):
            np.testing.assert_array_equal(t.numpy(), want[k].numpy(), err_msg=k)


def small_quantized_pair():
    """(JAX net, quantized and calibrated JAX variables, port net quantized
    the same way) for the bridge tests."""
    batches = [X, X * 0.5]
    return calibrate_both(JNet(), PortNet(), batches, 32)


def test_bridge_loads_a_calibrated_tree_strictly():
    sv, port = small_quantized_pair()
    fresh = PortNet()
    quantize_for_int8_conv(port_with(fresh, seeded_variables(JNet(), X, seed=39)), 32)
    for m in fresh.modules():  # static scales, ready for the tree's x_scale
        if isinstance(m, tl.Int8Conv2d):
            m.input_scale = torch.zeros(())
    fresh.load_state_dict(variables_to_state_dict(sv, fresh), strict=True)
    for k, t in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
    np.testing.assert_array_equal(from_port(fresh(to_port(X))),
                                  np.asarray(JNet().apply(sv, X)))


def test_bridge_rejects_quantized_trees_that_do_not_fit():
    sv, port = small_quantized_pair()
    missing = jax.tree.map(lambda a: a, sv)
    del missing["params"]["c2"]["x_scale"]
    with pytest.raises(KeyError, match="no flax leaf"):
        variables_to_state_dict(missing, port)
    wrong = jax.tree.map(lambda a: a, sv)
    wrong["params"]["c2"]["x_scale"] = jnp.ones((64,), jnp.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        variables_to_state_dict(wrong, port)
    float_w = jax.tree.map(lambda a: a, sv)
    float_w["params"]["c3"]["w"] = float_w["params"]["c3"]["w"].astype(jnp.float32)
    with pytest.raises(ValueError, match="dtype mismatch"):
        variables_to_state_dict(float_w, port)
    extra = jax.tree.map(lambda a: a, sv)
    extra["params"]["c3"]["x_zero"] = jnp.zeros(())
    with pytest.raises(KeyError):
        variables_to_state_dict(extra, port)
