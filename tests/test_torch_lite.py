"""The port's Lite family (models/efficientnet.py::EfficientNetEncoder,
models/lite/: ConvBNReLU, ASPP, DeepLabV3Plus, UnetPlusPlus and
build_lite_model), models/yolo_layers.py::PSA, the ``bn`` rule of
convert/from_jax.py and train/metrics.py against the JAX package's, on the
CPU in f32.

Weights and inputs are drawn with numpy from seeds; the JAX variables load
into the port through convert/from_jax.py with strict=True. The nets at
full width and depth on 64x128 inputs (the stride-32 map 2x4); atol 2e-4,
rtol 1e-3 (tests/test_models_parity.py's bar). One jitted JAX apply per
net. The metrics are exact.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.models import efficientnet as jeff
from autoware_vision_pilot_tpu.models import yolo_layers as jyolo
from autoware_vision_pilot_tpu.models.lite import build_lite_model as j_build
from autoware_vision_pilot_tpu.models.lite import deeplabv3plus as jdl
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.train import metrics as jmetrics
from autoware_vision_pilot_tpu.train.lite_trainer import load_experiment_config as j_load_cfg

from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.models import efficientnet as teff
from autoware_vision_pilot_tpu_torch.models import yolo_layers as tyolo
from autoware_vision_pilot_tpu_torch.models.lite import (DeepLabV3Plus, UnetPlusPlus,
                                                         build_lite_model)
from autoware_vision_pilot_tpu_torch.models.lite import deeplabv3plus as tdl
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.train import metrics as tmetrics
from autoware_vision_pilot_tpu_torch.train.lite_trainer import load_experiment_config

from test_torch_layers import P, assert_close, normal_input, port_with, seeded_variables, to_port

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
IMAGE = (1, 64, 128, 3)
STAGES = {"b0": (jeff.B0_STAGES, teff.B0_STAGES), "b1": (jeff.B1_STAGES, teff.B1_STAGES)}


def held(jmod, port, *inputs, seed):
    """``port`` with ``jmod``'s seeded variables, both on ``inputs`` (NHWC
    numpy) -> (JAX outputs, port outputs as NHWC numpy), the JAX apply
    jitted."""
    v = seeded_variables(jmod, *inputs, seed=seed)
    port = port_with(port, v)
    ref = jax.jit(jmod.apply)(v, *inputs)
    with torch.no_grad():
        out = port(*(to_port(x) for x in inputs))
    return ref, out


def lite_config(name):
    """(JAX config, port config) of configs/<name>.yaml; ``unetplusplus``:
    SceneSegLite's with ``model: unetplusplus``."""
    file = CONFIGS / ("SceneSegLite.yaml" if name == "unetplusplus" else f"{name}.yaml")
    jcfg, tcfg = j_load_cfg(file), load_experiment_config(file)
    assert jcfg == tcfg
    if name == "unetplusplus":
        for cfg in (jcfg, tcfg):
            cfg["network"]["model"] = "unetplusplus"
    return jcfg, tcfg


@pytest.mark.parametrize("stages,output_stride", [("b0", 8), ("b0", 16), ("b0", 32),
                                                  ("b1", 16)])
def test_efficientnet_encoder(stages, output_stride):
    js, ts = STAGES[stages]
    x = normal_input(IMAGE, seed=1)
    ref, out = held(jeff.EfficientNetEncoder(js, output_stride, precision=P),
                    teff.EfficientNetEncoder(ts, output_stride), x, seed=output_stride)
    strides = [2, 4, 8, min(16, output_stride), min(32, output_stride)]
    assert len(out) == len(ref) == 5
    for y, r, s, c in zip(out, ref, strides, (32, 24, 40, 112, 320)):
        assert tuple(y.shape) == (1, c, IMAGE[1] // s, IMAGE[2] // s)
        assert_close(y, r)


@pytest.mark.parametrize("kernel,dilation,separable", [(1, 1, False), (3, 2, False),
                                                       (3, 12, True), (3, 1, True)])
def test_conv_bn_relu(kernel, dilation, separable):
    x = normal_input((1, 16, 24, 40), seed=2)
    ref, out = held(jdl.ConvBNReLU(24, kernel, dilation, separable, precision=P),
                    tdl.ConvBNReLU(40, 24, kernel, dilation, separable), x, seed=kernel + dilation)
    assert_close(out, ref)


def test_aspp():
    x = normal_input((1, 8, 16, 320), seed=3)
    ref, out = held(jdl.ASPP(64, (12, 24, 36), precision=P), tdl.ASPP(320, 64), x, seed=4)
    assert tuple(out.shape) == (1, 64, 8, 16)
    assert_close(out, ref)


# name -> (port class, output (channels, height, width))
LITE = {"SceneSegLite": (DeepLabV3Plus, (3, 64, 128)),
        "Scene3DLite": (DeepLabV3Plus, (1, 64, 128)),
        "EgoLanesLite": (DeepLabV3Plus, (3, 16, 32)),  # head_upsampling 1: the OS=1/4 masks
        "unetplusplus": (UnetPlusPlus, (3, 64, 128))}


@pytest.mark.parametrize("name", list(LITE))
def test_lite_net(name):
    """Each Lite net from its config through build_lite_model, at full
    width and depth, strict weights, within the bar."""
    jcfg, tcfg = lite_config(name)
    cls, shape = LITE[name]
    port = build_lite_model(tcfg)
    assert type(port) is cls
    x = normal_input(IMAGE, seed=5)
    ref, out = held(j_build(jcfg, precision=P), port, x, seed=20 + list(LITE).index(name))
    assert tuple(out.shape) == (1, *shape)
    assert_close(out, ref)
    if name == "Scene3DLite":  # sigmoid
        assert out.min() >= 0 and out.max() <= 1


def test_build_lite_model_keeps_the_jax_rules():
    ego = build_lite_model(load_experiment_config(CONFIGS / "EgoLanesLite.yaml"))
    assert ego.head_upsampling == 1 and ego.head_activation is None
    assert tuple(ego.head.weight.shape) == (3, 64, 3, 3)  # decoder 64
    assert ego.aspp.b3.dw.dilation == (36, 36)
    seg = build_lite_model(load_experiment_config(CONFIGS / "SceneSegLite.yaml"),
                           output_stride=8, decoder_channels=32)
    assert seg.aspp.b0.conv.weight.shape[0] == 32
    assert seg.encoder.s4[0].block[1][0].dilation == (2, 2)  # stride 16 -> dilation at OS 8
    with pytest.raises(ValueError, match="unknown lite model"):
        build_lite_model({"network": {"model": "fcn"}})


def test_psa():
    x = normal_input((1, 6, 10, 256), seed=6)
    ref, out = held(jyolo.PSA(256, 2, precision=P), tyolo.PSA(256, 2), x, seed=7)
    assert_close(out, ref)


def test_from_jax_bn_rule_both_ways():
    """A path part ``bn`` is kept where the module has a BatchNorm named
    ``bn`` (the Lite ConvBNReLU) and dropped for the JAX BatchNorm2d
    wrapper's inner module; a leaf with no place still raises."""
    x = normal_input((1, 4, 4, 8), seed=8)
    v = seeded_variables(jdl.ConvBNReLU(8, 1), x, seed=9)
    assert "bn" in v["params"] and "bn" in v["batch_stats"]
    sd = variables_to_state_dict(v, tdl.ConvBNReLU(8, 8, 1))
    assert {"bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"} <= set(sd)
    np.testing.assert_array_equal(sd["bn.weight"].numpy(), v["params"]["bn"]["scale"])
    w = seeded_variables(jl.BatchNorm2d(), x, seed=10)
    assert set(w["params"]) == {"bn"}
    sd = variables_to_state_dict(w, tl.BatchNorm2d(8))
    assert set(sd) == {"weight", "bias", "running_mean", "running_var"}
    np.testing.assert_array_equal(sd["running_var"].numpy(), w["batch_stats"]["bn"]["var"])
    with pytest.raises(KeyError):  # conv/w has no place in a separable ConvBNReLU
        variables_to_state_dict(v, tdl.ConvBNReLU(8, 8, 3, separable=True))


@pytest.mark.parametrize("ignore_index", [None, 255])
def test_confusion_matrix_and_miou(ignore_index):
    rng = np.random.default_rng(11)
    pred = rng.integers(0, 5, (2, 40, 60))
    gt = rng.integers(0, 5, (2, 40, 60))
    gt[0, :7] = 255  # ignored where ignore_index is 255
    gt[1, 3, :5] = 3
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), 6,
                                                ignore_index=ignore_index))
    got = tmetrics.confusion_matrix(pred, gt, 6, ignore_index=ignore_index)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == (gt != 255).sum()  # 255 * 6 + p lies past the matrix either way
    j_iou, j_miou, j_overall = jmetrics.miou_from_confusion(want)
    t_iou, t_miou, t_overall = tmetrics.miou_from_confusion(got)
    np.testing.assert_array_equal(t_iou, j_iou)  # class 5: never seen, NaN on both
    assert np.isnan(t_iou[5]) and (t_miou, t_overall) == (j_miou, j_overall)


RESIZES = (((25, 50), (100, 200)), ((32, 64), (128, 256)), ((13, 25), (25, 50)),
           ((10, 20), (20, 40)), ((128, 256), (512, 1024)), ((100, 200), (400, 800)))


@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}"
                                                  for a, b in RESIZES])
def test_resize_to_matches_jax_image_resize(src, dst):
    """The Lite nets' bilinear upsamples (ASPP to the stride-4 skip, UNet++'s
    x2, the heads' x4 and x2): F.interpolate(align_corners=False) against
    jax.image.resize(..., "bilinear") on unit-normal inputs, within 2e-6
    (a few f32 ulps at |x| ~ 4: both lerp between the same two taps, in
    another order)."""
    x = normal_input((1, *src, 3), seed=12)
    ref = jax.image.resize(jnp.asarray(x), (1, *dst, 3), method="bilinear")
    out = tdl._resize_to(to_port(x), torch.empty(1, 1, *dst))
    gap = np.abs(out.permute(0, 2, 3, 1).numpy() - np.asarray(ref)).max()
    assert gap <= 2e-6, gap
