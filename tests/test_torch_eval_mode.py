"""Every serving entry point of the port builds its networks in eval mode.

A module starts in training mode, and the port's BatchNorm, Dropout and
stochastic depth now follow ``Module.training``: a net left in training
mode would normalize with batch statistics, move its running statistics
and ask for dropout masks while it serves. Each entry point is built on
the CPU (small sizes where it takes them) and every ``nn.Module`` it
holds, found through its attributes, must have ``training`` False.
"""
import argparse
import pathlib

import numpy as np
import pytest
import torch
from torch import nn

from autoware_vision_pilot_tpu_torch import app, inference
from autoware_vision_pilot_tpu_torch.export import eval_lite
from autoware_vision_pilot_tpu_torch.export.quantize import quantize_for_int8_conv
from autoware_vision_pilot_tpu_torch.middleware.backend import backend_from_params
from autoware_vision_pilot_tpu_torch.middleware.nodes import launch_pipeline
from autoware_vision_pilot_tpu_torch.middleware.transport import InProcTransport
from autoware_vision_pilot_tpu_torch.models import EgoLanesNetwork, SceneSegNetwork
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.models.lite import build_lite_model
from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused
from autoware_vision_pilot_tpu_torch.runtime.config import Config
from autoware_vision_pilot_tpu_torch.runtime.fleet import (FleetLateralPipeline,
                                                           FleetLongitudinalPipeline)
from autoware_vision_pilot_tpu_torch.runtime.pipeline import (build_lateral_pipeline,
                                                              build_longitudinal_pipeline)
from autoware_vision_pilot_tpu_torch.train.lite_trainer import load_experiment_config

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
CPU = dict(device="cpu", dtype=torch.float32)


def modules_of(obj, seen=None, depth=0):
    """Every nn.Module reachable from ``obj`` through attributes, dicts,
    lists, tuples and the closures of functions (the pipelines' steps)."""
    seen = set() if seen is None else seen
    if id(obj) in seen or depth > 5 or isinstance(obj, (torch.Tensor, np.ndarray, str,
                                                         bytes, type)):
        return []
    seen.add(id(obj))
    if isinstance(obj, nn.Module):
        return list(obj.modules())
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    elif getattr(obj, "__closure__", None):
        items = [c.cell_contents for c in obj.__closure__]
    elif hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return []
    return [m for v in items for m in modules_of(v, seen, depth + 1)]


def assert_eval(obj, least=1):
    mods = modules_of(obj)
    assert len(mods) >= least
    training = sorted({type(m).__name__ for m in mods if m.training})
    assert not training, f"modules in training mode: {training}"


def test_fused_pipeline_and_int8_swap():
    pipe = build_pipeline_fused("cpu", torch.float32, ctx_hw=(2, 4), out_hw=(64, 128))
    assert_eval(pipe, 100)
    # build_pipeline_fused(int8=True) and the int8 wrappers swap convs in
    # place: the int8 modules take the mode of the convs they replace
    assert_eval(quantize_for_int8_conv(pipe.lanes, 32), 100)
    assert_eval(quantize_for_int8_conv(pipe.stack, 256, quantize_transpose=True), 100)


def test_lateral_longitudinal_and_fleet():
    lat = build_lateral_pipeline("cpu", torch.float32, frame_hw=(120, 200), crop_y=20,
                                 net_hw=(96, 192), backbone_stages=B0_DRYRUN_STAGES)
    lon = build_longitudinal_pipeline("cpu", torch.float32, frame_hw=(180, 320),
                                      input_hw=(128, 128))
    assert_eval(lat, 50)
    assert_eval(lon, 50)
    assert_eval(FleetLateralPipeline(lat.lanes, lat.steer_net, Config(), 2, frame_hw=(120, 200),
                                     crop_y=20, dtype=torch.float32, net_hw=(96, 192)), 50)
    assert_eval(FleetLongitudinalPipeline(lon.net, Config(), 2, frame_hw=(180, 320),
                                          input_hw=(128, 128), dtype=torch.float32), 50)


def test_engine():
    assert_eval(app.build_engine(Config(), lambda: None, dtype=torch.float32, device="cpu"), 150)


def test_inference_wrappers_and_backend():
    small = dict(input_hw=(64, 128), device="cpu")
    for w in (inference.SceneSegInfer(model=SceneSegNetwork((2, 4), B0_DRYRUN_STAGES, **CPU),
                                      **small),
              inference.EgoLanesInfer(model=EgoLanesNetwork((2, 4), B0_DRYRUN_STAGES, **CPU),
                                      **small),
              inference.Scene3DInfer(device="cpu"), inference.DomainSegInfer(device="cpu"),
              inference.AutoSpeedInfer(frame_hw=(180, 320), input_hw=(128, 128), device="cpu"),
              inference.AutoSteerInfer(device="cpu")):
        assert_eval(w, 9)
    for kind in ("segmentation", "depth", "egolanes"):
        assert_eval(backend_from_params({"model_type": kind, "precision": "fp32"}, "cpu"), 50)


def test_lite_cli_net():
    cfg = load_experiment_config(CONFIGS / "SceneSegLite.yaml")
    args = argparse.Namespace(onnx=None, msgpack=None, checkpoint=None)
    assert_eval(eval_lite.load_weights(build_lite_model(cfg), args, "cpu", torch.float32), 50)


def test_middleware_nodes():
    params = {"seg": {"ros__parameters": {"model_type": "segmentation", "precision": "fp32"}},
              "det": {"ros__parameters": {"model_type": "detection"}}}
    nodes = launch_pipeline(InProcTransport(), params, device="cpu")
    assert set(nodes) == {"seg", "det"}
    assert_eval(nodes, 100)


def test_a_net_left_in_training_mode_is_caught():
    net = init_seeded(SceneSegNetwork((2, 4), B0_DRYRUN_STAGES), torch.Generator())
    with pytest.raises(AssertionError, match="training mode"):
        assert_eval({"net": net})
