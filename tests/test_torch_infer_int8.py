"""The port's int8 inference wrappers (inference/infer.py with
precision="int8" and int8_min_channels=128) against the JAX package's, on
the CPU in f32, conv by conv: the port's int8 convs run the kernels' plain
versions here (ops/kernels/int8_conv.py).

Why conv by conv: the int8 path is chaotic under float drift (ROADMAP
Queue 3, tests/test_torch_int8_slice.py): the float layers between the
int8 convs agree with XLA's to ~1e-7 of their range, and one int8 value
that crosses a rounding boundary multiplies through every int8 conv after
it. So, for SceneSeg and EgoLanes at dryrun depth (this file) and Scene3D
at full depth (tests/test_torch_infer_int8_full.py, which imports this
file's helpers), at 64x128 inputs, ctx_hw=(2, 4), on 128x256 frames:

- the same convs are selected (at least 128 input channels a group);
- while each wrapper calibrates on its four N(0, 1) batches from
  ``default_rng(7)``, every int8 conv of the port is fed the input the JAX
  wrapper's conv saw in the same call (a global forward pre-hook), so the
  two calibrations see the same activations;
- then the port's state_dict equals, bit for bit, the one JAX's variables
  (quantize_variables_for_int8_conv, then calibrate_int8_activation_scales)
  convert to: int8 weights, weight scales, input scales and float leaves;
- on a frame, each int8 conv fed JAX's input gives JAX's int32
  accumulators (lax.conv_general_dilated on int8, as nn/layers.py:110-111)
  and JAX's output, bit for bit; JAX runs op by op (under jit XLA:CPU
  contracts the dequant and bias into an FMA: tests/test_torch_int8.py).

DomainSeg (whose JAX network has no dryrun depth) is held by its int8
convs' shapes: each is one that the Scene3D or SceneSeg case holds.

Each file takes ~1.5 min alone, most of it XLA compiling the primitives of
JAX's eager applies (its calibration applies the model op by op) on first
use.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from autoware_vision_pilot_tpu.inference import infer as jinfer
from autoware_vision_pilot_tpu.models.domain_seg import DomainSegNetwork as JDomain
from autoware_vision_pilot_tpu.models.efficientnet import B0_DRYRUN_STAGES as J_DRYRUN
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JLanes
from autoware_vision_pilot_tpu.models.scene_3d import Scene3DNetwork as JScene3D
from autoware_vision_pilot_tpu.models.scene_seg import SceneSegNetwork as JSceneSeg
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.ops.preprocess import preprocess_imagenet as j_preprocess

from autoware_vision_pilot_tpu_torch import inference as tinfer
from autoware_vision_pilot_tpu_torch.convert.from_jax import _merge_digits, variables_to_state_dict
from autoware_vision_pilot_tpu_torch.export.quantize import int8_conv_count, quantize_for_int8_conv
from autoware_vision_pilot_tpu_torch.models import (DomainSegNetwork, EgoLanesNetwork,
                                                    Scene3DNetwork, SceneSegNetwork)
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv, int8_quantize

from test_torch_layers import jax_int8_calls, port_int8_calls, seeded_variables, to_port

IN_HW, CTX, MIN_CH = (64, 128), (2, 4), 128
FRAME = np.random.default_rng(1).integers(0, 256, (128, 256, 3), dtype=np.uint8)

# name -> (JAX network, port network, JAX wrapper, port wrapper, int8 convs)
NETS = {
    "scene_seg": (lambda: JSceneSeg(ctx_hw=CTX, backbone_stages=J_DRYRUN),
                  lambda: SceneSegNetwork(CTX, B0_DRYRUN_STAGES),
                  jinfer.SceneSegInfer, tinfer.SceneSegInfer, 20),
    "scene_3d": (lambda: JScene3D(ctx_hw=CTX), lambda: Scene3DNetwork(CTX),
                 jinfer.Scene3DInfer, tinfer.Scene3DInfer, 47),
    "domain_seg": (lambda: JDomain(ctx_hw=CTX), lambda: DomainSegNetwork(CTX),
                   jinfer.DomainSegInfer, tinfer.DomainSegInfer, 46),
    "ego_lanes": (lambda: JLanes(ctx_hw=CTX, backbone_stages=J_DRYRUN),
                  lambda: EgoLanesNetwork(CTX, B0_DRYRUN_STAGES),
                  jinfer.EgoLanesInfer, tinfer.EgoLanesInfer, 19),
}


def jax_calls_during(build):
    """build() with every int8 conv call of the JAX package recorded ->
    (its result, [(path, input)] in call order)."""
    calls = []

    def intercept(next_fun, args, kwargs, context):
        m = context.module
        if (isinstance(m, jl.Conv2d) and context.method_name == "__call__"
                and m.has_variable("params", "w_scale")):
            calls.append((".".join(m.path), np.array(args[0])))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(intercept):
        out = build()
    return out, calls


def port_calls_during(build, inputs):
    """build() with every Int8Conv2d call fed the next of ``inputs`` (NHWC)
    -> (its result, the modules in call order)."""
    seen = []

    def pre(m, args):
        if isinstance(m, tl.Int8Conv2d):
            seen.append(m)
            return (to_port(inputs[len(seen) - 1]).contiguous(memory_format=torch.channels_last),)

    handle = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    try:
        out = build()
    finally:
        handle.remove()
    return out, seen


def build_wrappers(name):
    """The JAX and port int8 wrappers of ``name`` on the same seeded
    variables, the port's calibration fed JAX's int8 conv inputs ->
    (name, JAX wrapper, port wrapper, JAX calibration calls, the port's
    calibrated modules in call order)."""
    jnet, port_net, jwrap, twrap, _ = NETS[name]
    v = seeded_variables(jnet(), jax.ShapeDtypeStruct((1, *IN_HW, 3), jnp.float32),
                         seed=100 + list(NETS).index(name))
    kw = dict(variables=v, input_hw=IN_HW, precision="int8", int8_min_channels=MIN_CH)
    j, cal_calls = jax_calls_during(lambda: jwrap(model=jnet(), **kw))
    t, cal_modules = port_calls_during(
        lambda: twrap(model=port_net(), device="cpu", **kw), [c[1] for c in cal_calls])
    return name, j, t, cal_calls, cal_modules


@pytest.fixture(scope="module", params=["scene_seg", "ego_lanes"])
def wrappers(request):
    return build_wrappers(request.param)


def check_weights_and_scales(wrappers):
    name, j, t, cal_calls, cal_modules = wrappers
    count = NETS[name][4]
    jax_count = sum(leaf.dtype == jnp.int8 for path, leaf in
                    jax.tree_util.tree_leaves_with_path(j.variables["params"])
                    if path[-1].key == "w")
    assert int8_conv_count(t.model) == jax_count == count
    assert len(cal_calls) == len(cal_modules) == 4 * count
    names = {m: n for n, m in t.model.named_modules()}
    assert [_merge_digits(names[m]) for m in cal_modules] == [p for p, _ in cal_calls]
    want = variables_to_state_dict(j.variables, t.model)
    got = t.model.state_dict()
    assert set(got) == set(want)
    scales = [k for k in want if k.endswith("input_scale")]
    assert len(scales) == count
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def check_conv_by_conv(wrappers):
    name, j, t, _, _ = wrappers
    xj = j_preprocess(jnp.asarray(FRAME)[None], IN_HW)
    _, jax_calls = jax_int8_calls(j.model, j.variables, xj)
    calls, remove = port_int8_calls([t.model], [c[1] for c in jax_calls])
    try:
        t.inference(FRAME)
    finally:
        remove()
    assert len(calls) == len(jax_calls) == NETS[name][4]
    params = j.variables["params"]
    for (pname, x, y, m), (path, xj_in, yj) in zip(calls, jax_calls):
        assert _merge_digits(pname) == path
        np.testing.assert_array_equal(y, yj, err_msg=pname)
        # the int32 accumulators of the same int8 input on both sides
        node = params
        for p in path.split("."):
            node = node[p]
        sx = np.asarray(node["x_scale"], np.float32)
        xq = np.clip(np.round(np.asarray(xj_in, np.float32) / sx), -127, 127).astype(np.int8)
        pad = m.padding[0]
        acc_j = lax.conv_general_dilated(
            xq, node["w"], (1, 1), [(pad, pad), (pad, pad)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
        xq_t = int8_quantize(to_port(x).contiguous(memory_format=torch.channels_last),
                             m.input_scale)
        np.testing.assert_array_equal(xq_t.permute(0, 2, 3, 1).numpy(), xq, err_msg=pname)
        acc_t = int8_conv(xq_t, m.weight, m.weight_scale, m.input_scale, None, m.padding,
                          torch.int32)
        np.testing.assert_array_equal(acc_t.permute(0, 2, 3, 1).numpy(), np.asarray(acc_j),
                                      err_msg=pname)


def test_int8_wrapper_weights_and_scales_equal_jax(wrappers):
    check_weights_and_scales(wrappers)


def test_int8_wrapper_conv_by_conv_equals_jax(wrappers):
    check_conv_by_conv(wrappers)


def int8_conv_shapes(net):
    """(input shape, weight shape, padding) of each int8 conv call of
    ``net`` quantized at MIN_CH, on a zero input at IN_HW, in call order."""
    quantize_for_int8_conv(net, MIN_CH)
    calls = []

    def pre(m, args):
        if isinstance(m, tl.Int8Conv2d):
            calls.append((tuple(args[0].shape), tuple(m.weight.shape), m.padding))

    handle = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    try:
        with torch.inference_mode():
            net.eval()(torch.zeros(1, 3, *IN_HW))
    finally:
        handle.remove()
    return calls


def test_domain_seg_int8_shapes_are_held_by_scene_3d_and_scene_seg():
    """DomainSeg's int8 convs at min_channels 128 (its full-depth B0 trunk,
    context and neck, and SegHead(1)) are each a shape that the Scene3D
    (full-depth trunk) or SceneSeg (SegHead) case holds against JAX."""
    calls = {name: int8_conv_shapes(NETS[name][1]())
             for name in ("scene_seg", "scene_3d", "domain_seg")}
    assert len(calls["domain_seg"]) == NETS["domain_seg"][4]
    assert set(calls["domain_seg"]) <= set(calls["scene_3d"]) | set(calls["scene_seg"])
