"""The selective-int8 main path with the transposed convs in int8 as well:
bench.py::build_pipeline_fused at full width and depth, then
quantize_for_int8_conv(..., 256, quantize_transpose=True) on each network,
against JAX's quantize_variables_for_int8_conv(..., quantize_transpose=
True) and calibration, in f32 on the CPU (the port's int8 modules run the
kernels' plain versions). tests/test_torch_int8_slice.py's size: a 72x128
frame -> out_hw (32, 64), ctx_hw (1, 2), two noise calibration batches.

83 int8 modules a frame: 72 convs and 11 transposed convs (SceneNeck and
DepthNeck at 1280, 768 and 512 input channels, both heads'
upsample_layer_3 at 256, EgopathNeck at 1456, 768 and 512). As in
test_torch_int8_slice.py, the float layers between them agree with XLA's
to ~3e-7, not bit for bit, so each port module is fed the input JAX's
module saw (forward pre-hooks) and must give JAX's output bit for bit.
JAX runs op by op (eager apply): under jit XLA:CPU contracts the dequant
multiply and the bias add into one FMA.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.export.quantize import (
    calibrate_int8_activation_scales as jax_calibrate,
    quantize_variables_for_int8_conv as jax_quantize)
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JEgoLanes
from autoware_vision_pilot_tpu.models.multitask import SharedPerceptionStack as JStack
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.ops import preprocess_imagenet
from autoware_vision_pilot_tpu_torch.convert.from_jax import (
    _merge_digits, variables_to_state_dict)
from autoware_vision_pilot_tpu_torch.export.quantize import (
    int8_conv_count, int8_transpose_count, quantize_for_int8_conv)
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused

from test_torch_layers import from_port, seeded_variables, to_port
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

OUT_HW, CTX_HW, MIN_CH = (32, 64), (1, 2), 256
INT8 = (tl.Int8Conv2d, tl.Int8ConvTranspose2d)


def jax_int8_calls(jmod, variables, x):
    """Eager apply -> (outputs, [(path, input, output)] of every int8 conv
    and int8 transposed conv, in call order)."""
    calls = []

    def intercept(next_fun, args, kwargs, context):
        y = next_fun(*args, **kwargs)
        m = context.module
        if context.method_name == "__call__" and (
                (isinstance(m, jl.Conv2d) and m.has_variable("params", "w_scale"))
                or (isinstance(m, jl.ConvTranspose2d) and m.has_variable("params", "wt_scale"))):
            calls.append((".".join(m.path), np.array(args[0]), np.array(y)))
        return y

    with fnn.intercept_methods(intercept):
        out = jmod.apply(variables, x)
    return out, calls


def port_int8_calls(nets, forced):
    """Hooks on every int8 module of ``nets``: each is fed the next array
    of ``forced`` (NHWC) and records (name, NHWC output)."""
    calls = []
    names = {m: n for net in nets for n, m in net.named_modules()}

    def pre(m, args):
        return (to_port(forced[len(calls)]).contiguous(memory_format=torch.channels_last),)

    def post(m, args, y):
        calls.append((names[m], from_port(y)))

    handles = [h for m in names if isinstance(m, INT8)
               for h in (m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
    return calls, lambda: [h.remove() for h in handles]


@pytest.fixture(scope="module")
def slice_calls():
    x = jax.ShapeDtypeStruct((1, *OUT_HW, 3), jnp.float32)
    rng = np.random.default_rng(7)
    cal = [jnp.asarray(rng.normal(0.0, 1.0, x.shape), jnp.float32) for _ in range(2)]
    pipe = build_pipeline_fused("cpu", torch.float32, seed=0, ctx_hw=CTX_HW, out_hw=OUT_HW)
    jmods = (JStack(ctx_hw=CTX_HW, with_domain=False), JEgoLanes(ctx_hw=CTX_HW))
    qvs = []
    for jmod, module, seed in zip(jmods, (pipe.stack, pipe.lanes), (40, 41)):
        qv = jax_calibrate(jmod, jax_quantize(seeded_variables(jmod, x, seed=seed), MIN_CH,
                                              quantize_transpose=True), cal)
        quantize_for_int8_conv(module, MIN_CH, quantize_transpose=True)
        for m in module.modules():  # static scales, ready for the tree's x_scale
            if isinstance(m, INT8):
                m.input_scale = torch.zeros(())
        module.load_state_dict(variables_to_state_dict(qv, module), strict=True)
        qvs.append(qv)
    frame = np.random.default_rng(42).integers(0, 256, (72, 128, 3), np.uint8)
    xj = preprocess_imagenet(jnp.asarray(frame)[None], OUT_HW, dtype=jnp.float32)
    _, stack_calls = jax_int8_calls(jmods[0], qvs[0], xj)
    _, lanes_calls = jax_int8_calls(jmods[1], qvs[1], xj)
    jax_calls = stack_calls + lanes_calls
    calls, remove = port_int8_calls((pipe.stack, pipe.lanes), [c[1] for c in jax_calls])
    try:
        pipe.logits(torch.from_numpy(frame))
    finally:
        remove()
    return dict(pipe=pipe, qvs=qvs, jax_calls=jax_calls, calls=calls)


def test_83_int8_modules_selected_as_jax_selects_them(slice_calls):
    pipe = slice_calls["pipe"]
    transposes = [sum(leaf.dtype == jnp.int8 for path, leaf in
                      jax.tree_util.tree_leaves_with_path(qv["params"])
                      if path[-1].key == "wt") for qv in slice_calls["qvs"]]
    assert transposes == [int8_transpose_count(pipe.stack), int8_transpose_count(pipe.lanes)] \
        == [8, 3]
    assert [int8_conv_count(pipe.stack), int8_conv_count(pipe.lanes)] == [41, 31]
    names = [n for net in (pipe.stack, pipe.lanes) for n, m in net.named_modules()
             if isinstance(m, tl.Int8ConvTranspose2d)]
    assert sorted(n.rsplit(".", 1)[-1] for n in names) == sorted(
        ["upsample_layer_0", "upsample_layer_1", "upsample_layer_2"] * 3
        + ["upsample_layer_3"] * 2)
    calls = slice_calls["calls"]
    assert len(calls) == len(slice_calls["jax_calls"]) == 83
    assert [_merge_digits(c[0]) for c in calls] == [c[0] for c in slice_calls["jax_calls"]]


def test_every_int8_module_matches_jax_bit_for_bit(slice_calls):
    for (name, y), (path, _, want) in zip(slice_calls["calls"], slice_calls["jax_calls"]):
        np.testing.assert_array_equal(y, want, err_msg=f"{name} ({path})")
