"""The port's QAT export (autoware_vision_pilot_tpu_torch/train/qat.py::
int8_variables_from_qat onto export/quantize.py::quantize_for_int8_conv)
against the JAX package's, on the CPU: on JAX's tiny QAT model and on
SceneSeg at dryrun depth (B0_DRYRUN_STAGES, ctx_hw (2, 4), 64x128), with
the scales JAX's observers gave (tests/test_torch_qat.py::jax_qat).

The int8 modules hold JAX's int8 variables bit for bit, and are held to
JAX's int8 path conv by conv: each port Int8Conv2d is fed the input JAX's
int8 conv saw (a jitted apply of JAX's int8 tree, the inputs sown), and
its output must equal, bit for bit, JAX's int8 branch on that input. That
branch is run jitted without its bias, and the bias added in f32 after, as
JAX computes it op by op: jitted whole, XLA would contract the dequant
product and the bias add into one FMA (one rounding in place of two). The
JAX quantization itself runs op by op (jitted, XLA turns / 127 into a
product).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.models import efficientnet as je
from autoware_vision_pilot_tpu.models.scene_seg import SceneSegNetwork as JSceneSeg
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.train import qat as jqat
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.models import efficientnet as te
from autoware_vision_pilot_tpu_torch.models.scene_seg import SceneSegNetwork
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.train import qat as tqat

from test_torch_layers import from_port, port_with, seeded_variables, to_port
from test_torch_qat import CTX, HW, JTiny, Tiny, jax_qat, name_map, rnd
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)


def jax_int8_inputs(jmod, qv, x):
    """A jitted apply of JAX's int8 tree -> {path: input} of every int8
    conv."""
    def intercept(next_fun, args, kwargs, context):
        m = context.module
        if (isinstance(m, jl.Conv2d) and context.method_name == "__call__"
                and m.has_variable("params", "w_scale")):
            m.sow("intermediates", "int8_in", args[0])
        return next_fun(*args, **kwargs)

    inputs = {}

    @jax.jit
    def run(vv, xx):
        with fnn.intercept_methods(intercept):
            return jmod.apply(vv, xx, mutable=["intermediates"])[1]["intermediates"]

    def walk(node, path):
        for k, v in node.items():
            if k == "int8_in":
                inputs[tuple(path)] = np.asarray(v[0])
            elif isinstance(v, dict):
                walk(v, path + [k])
    walk(jax.tree.map(np.asarray, run(qv, jnp.asarray(x))), [])
    return inputs


def jax_int8_conv(leaf, x):
    """JAX's int8 branch of Conv2d on ``x``: jitted without the bias, the
    bias then added in f32 (the op-by-op rounding)."""
    kh, kw, _, cout = leaf["w"].shape
    mod = jl.Conv2d(cout, (kh, kw), 1, (kh - 1) // 2, use_bias=False)
    params = {k: leaf[k] for k in ("w", "w_scale", "x_scale")}
    y = np.asarray(jax.jit(mod.apply)({"params": params}, jnp.asarray(x)))
    return y + np.asarray(leaf["b"]) if "b" in leaf else y


def leaf_of(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def export_both(jmod, port, v, x):
    _, _, jscales, _ = jax_qat(jmod, v, x)
    qv = jqat.int8_variables_from_qat(v, jscales, 32)
    port = port_with(port, v)
    names = name_map(port)
    int8 = tqat.int8_variables_from_qat(port, {names[p]: s for p, s in jscales.items()}, 32)
    return qv, port, int8, names


@pytest.mark.parametrize("net", ["tiny", "SceneSeg"])
def test_int8_export_conv_by_conv(net):
    if net == "tiny":
        jmod, port, x_hw = JTiny(), Tiny(), (16, 32)
    else:
        jmod, port = JSceneSeg(ctx_hw=CTX, backbone_stages=je.B0_DRYRUN_STAGES), \
            SceneSegNetwork(CTX, te.B0_DRYRUN_STAGES)
        x_hw = HW
    v = seeded_variables(jmod, jnp.zeros((1, *x_hw, 3)), seed=21)
    x = rnd((1, *x_hw, 3), 22)
    qv, port, int8, names = export_both(jmod, port, v, x)
    # the model trained on is left float; the copy is an eval-mode int8 net
    assert not any(isinstance(m, tl.Int8Conv2d) for m in port.modules())
    assert not int8.training and not any(p.requires_grad for p in int8.parameters())
    # weights, w_scale and the static x_scale: JAX's int8 tree, bit for bit
    want = variables_to_state_dict(qv, int8)
    for k, t in int8.state_dict().items():
        assert torch.equal(t, want[k]), k
    jinputs = jax_int8_inputs(jmod, qv, x)
    by_name = {names[p]: a for p, a in jinputs.items()}
    outputs = {}

    def force(m, args):
        return (to_port(by_name[m.name]).contiguous(memory_format=torch.channels_last),)

    def record(m, args, y):
        outputs[m.name] = from_port(y)

    handles = []
    for name, m in int8.named_modules():
        if isinstance(m, tl.Int8Conv2d):
            m.name = name
            assert m.input_scale is not None and m.input_scale.dim() == 0
            handles += [m.register_forward_pre_hook(force), m.register_forward_hook(record)]
    try:
        with torch.no_grad():
            int8(to_port(x))
    finally:
        for h in handles:
            h.remove()
    assert outputs.keys() == by_name.keys()
    assert len(outputs) == (2 if net == "tiny" else 30)
    for path, jx in jinputs.items():
        np.testing.assert_array_equal(outputs[names[path]],
                                      jax_int8_conv(leaf_of(qv["params"], path), jx),
                                      err_msg=names[path])
