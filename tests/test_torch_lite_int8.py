"""The port's Lite int8 path (export/eval_lite.py ``--int8``: the
selective quantizer and the calibration of export/quantize.py) against the
JAX package's, on the CPU in f32 at 64x128, conv by conv: the port's int8
convs run the kernels' plain versions here.

- Every Lite net at min_channels 128 (eval_lite's default): the same convs
  are selected (by name: 40 for SceneSegLite, 38 for Scene3DLite and
  EgoLanesLite, 48 for UNet++), with int8 weights and weight scales bit-equal
  to JAX's ``quantize_variables_for_int8_conv``.
- SceneSegLite through ``main(["--int8", ...])``: its four calibration
  batches equal JAX's CLI's; while it calibrates, every int8 conv is fed the
  input JAX's conv saw (a global forward pre-hook), so its input scales and
  whole state equal, bit for bit, what JAX's ``calibrate_int8_activation_
  scales`` writes; then, fed JAX's inputs, each int8 conv gives JAX's int32
  accumulators and JAX's output (its Conv2d applied op by op: jitted, XLA
  contracts the dequant and bias into an FMA).

JAX's calibration applies the model op by op, which compiles each
primitive on first use; here its apply is jitted (it sows the same
``act_amax``, the max of JAX's own activations, which the port is fed).
"""
import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from autoware_vision_pilot_tpu.export import quantize as jquant
from autoware_vision_pilot_tpu.export.checkpoints import save_msgpack
from autoware_vision_pilot_tpu.models.lite import build_lite_model as j_build
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

from autoware_vision_pilot_tpu_torch.convert.from_jax import _merge_digits, variables_to_state_dict
from autoware_vision_pilot_tpu_torch.export import eval_lite as teval
from autoware_vision_pilot_tpu_torch.export.quantize import quantize_for_int8_conv
from autoware_vision_pilot_tpu_torch.models.lite import build_lite_model
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv, int8_quantize

from test_torch_layers import port_with, seeded_variables, to_port
from test_torch_lite import lite_config

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
HW = (64, 128)
MIN_CH = 128
COUNTS = {"SceneSegLite": 40, "Scene3DLite": 38, "EgoLanesLite": 38, "unetplusplus": 48}


def int8_paths(tree, path=()):
    """The module paths of the int8 conv kernels of a JAX params tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from int8_paths(v, (*path, k))
        elif k == "w" and v.dtype == jnp.int8:
            yield ".".join(path)


def node_at(tree, path):
    for p in path.split("."):
        tree = tree[p]
    return tree


@pytest.mark.parametrize("name", list(COUNTS))
def test_lite_int8_selection_and_weights_equal_jax(name):
    _, cfg = lite_config(name)
    v = seeded_variables(j_build(cfg), jax.ShapeDtypeStruct((1, *HW, 3), jnp.float32),
                         seed=60 + list(COUNTS).index(name))
    q = jquant.quantize_variables_for_int8_conv(v, MIN_CH)
    port = quantize_for_int8_conv(port_with(build_lite_model(cfg), v), MIN_CH)
    names = [n for n, m in port.named_modules() if isinstance(m, tl.Int8Conv2d)]
    paths = list(int8_paths(q["params"]))
    assert len(names) == len(paths) == COUNTS[name]
    assert sorted(_merge_digits(n) for n in names) == sorted(paths)
    want = variables_to_state_dict(q, port)
    got = port.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def jax_calibration(model, variables, batches):
    """JAX's calibrate_int8_activation_scales on ``batches`` with the
    model's apply jitted -> (calibrated variables, [(path, input)] of each
    int8 conv call of the first batch, in call order, and of all batches)."""
    paths, calls = [], []

    @jax.jit
    def run(v, x):
        xs = []

        def intercept(next_fun, args, kwargs, context):
            m = context.module
            if (isinstance(m, jl.Conv2d) and context.method_name == "__call__"
                    and m.has_variable("params", "w_scale")):
                paths.append(".".join(m.path))  # at trace time, in call order
                xs.append(args[0])
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(intercept):
            out = model.apply(v, x, mutable=["intermediates"])
        return out, xs

    class Jitted:
        @staticmethod
        def apply(v, x, mutable):
            out, xs = run(v, x)
            calls.append([np.array(a) for a in xs])
            return out

    cal = jquant.calibrate_int8_activation_scales(Jitted, variables, batches)
    return cal, paths, calls


def test_lite_int8_eval_lite_conv_by_conv_equals_jax(monkeypatch, tmp_path):
    name = "SceneSegLite"
    _, cfg = lite_config(name)
    model = j_build(cfg)
    v = seeded_variables(model, jax.ShapeDtypeStruct((1, *HW, 3), jnp.float32), seed=70)
    save_msgpack(tmp_path / "w.msgpack", v)

    # JAX's CLI: quantize, then calibrate on four noise batches of two (eval_lite.py:127-133)
    q = jquant.quantize_variables_for_int8_conv(v, MIN_CH)
    rng = np.random.default_rng(11)
    batches = [(jnp.asarray(rng.integers(0, 256, (2, *HW, 3), dtype=np.uint8)).astype(
        jnp.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD for _ in range(4)]
    cal, paths, calls = jax_calibration(model, q, batches)
    count = COUNTS[name]
    assert len(paths) == count and [len(c) for c in calls] == [count] * 4
    fed = [x for c in calls for x in c]

    seen = {}
    calibrate = teval.calibrate_int8_activation_scales

    def calibrate_fed(port, port_batches):
        modules = []

        def pre(m, args):
            if isinstance(m, tl.Int8Conv2d):
                modules.append(m)
                return (to_port(fed[len(modules) - 1]).contiguous(
                    memory_format=torch.channels_last),)

        seen["batches"] = list(port_batches)
        handle = torch.nn.modules.module.register_module_forward_pre_hook(pre)
        try:
            calibrate(port, seen["batches"])
        finally:
            handle.remove()
        seen["model"], seen["modules"] = port, modules[:count]

    monkeypatch.setattr(teval, "calibrate_int8_activation_scales", calibrate_fed)
    summary = teval.main(["--config", str(CONFIGS / f"{name}.yaml"), "--msgpack",
                          str(tmp_path / "w.msgpack"), "--synthetic", "1", "--height",
                          str(HW[0]), "--width", str(HW[1]), "--int8", "--device", "cpu"])
    assert summary["samples"] == 1 and np.isfinite(summary["miou"])
    port = seen["model"]
    for got, want in zip(seen["batches"], batches):
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))

    names = {m: n for n, m in port.named_modules()}
    assert [_merge_digits(names[m]) for m in seen["modules"]] == paths
    want = variables_to_state_dict(cal, port)
    got = port.state_dict()
    assert set(got) == set(want)
    assert sum(k.endswith("input_scale") for k in want) == count
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k

    for m, path, x in zip(seen["modules"], paths, calls[0]):
        node = node_at(cal["params"], path)
        n, c, k, _ = m.weight.shape
        pad = m.padding[0]
        yj = jl.Conv2d(n, k, 1, pad, use_bias="b" in node).apply({"params": node}, x)
        xt = to_port(x).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            y = m(xt)
        np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(), np.asarray(yj),
                                      err_msg=path)
        sx = np.asarray(node["x_scale"], np.float32)
        xq = np.clip(np.round(x / sx), -127, 127).astype(np.int8)
        acc_j = lax.conv_general_dilated(xq, node["w"], (1, 1), [(pad, pad), (pad, pad)],
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                         preferred_element_type=jnp.int32)
        xq_t = int8_quantize(xt, m.input_scale)
        np.testing.assert_array_equal(xq_t.permute(0, 2, 3, 1).numpy(), xq, err_msg=path)
        acc = int8_conv(xq_t, m.weight, m.weight_scale, m.input_scale, None, m.padding,
                        torch.int32)
        np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), np.asarray(acc_j),
                                      err_msg=path)
