"""The port's AutoSpeed and AutoSteer inference wrappers
(inference/infer.py) and its middleware backend (middleware/backend.py)
against the JAX package's, on the CPU in f32.

Weights and frames are drawn with numpy from seeds; the JAX variables go
to both sides (the port loads them through convert/from_jax.py, strictly).
What is held, and why:
- AutoSpeed's pred, AutoSteer's logits: atol 2e-4, rtol 1e-3
  (tests/test_models_parity.py's bar);
- AutoSpeed's (N, 6) rows exactly when the port is fed JAX's pred and
  JAX's wrapper runs after it op by op (jitted, XLA contracts the decode's
  box arithmetic and lands an ulp away: tests/test_torch_longitudinal.py);
- AutoSteer's degrees exactly, its two best logits parting by more than
  DECIDED;
- backend_from_params on a weight file the JAX package's save_msgpack
  writes: the raw forward of the wrapper built from the same variables,
  bit for bit; the family by file stem or model_type and the dtype by
  precision as the JAX function picks them.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.export.checkpoints import save_msgpack
from autoware_vision_pilot_tpu.inference import infer as jinfer
from autoware_vision_pilot_tpu.models.auto_speed import AutoSpeedNetwork as JSpeed
from autoware_vision_pilot_tpu.models.auto_steer_temporal import AutoSteerTemporalNet as JSteer
from autoware_vision_pilot_tpu.models.domain_seg import DomainSegNetwork as JDomain
from autoware_vision_pilot_tpu.ops.preprocess import letterbox as j_letterbox

from autoware_vision_pilot_tpu_torch import inference as tinfer
from autoware_vision_pilot_tpu_torch.middleware import backend as tbackend
from autoware_vision_pilot_tpu_torch.models import (DomainSegNetwork, EgoLanesNetwork,
                                                    Scene3DNetwork, SceneSegNetwork)

from test_torch_layers import P, seeded_variables, to_port

FRAME = np.random.default_rng(0).integers(0, 256, (128, 256, 3), dtype=np.uint8)
DECIDED = 1e-3
ATOL, RTOL = 2e-4, 1e-3


def test_autospeed_wrapper():
    """Letterbox 128x256 -> 128x128 (scale 0.5, pad_y 32), AutoSpeed "n",
    decode, NMS at conf 0.25, IoU 0.45: the pred within the networks' bar;
    fed JAX's pred (a forward hook here, a stand-in model there), the
    (N, 6) rows equal JAX's."""
    frame_hw, input_hw = FRAME.shape[:2], (128, 128)
    jnet = JSpeed(variant="n", num_classes=4, img_h=128, img_w=128, precision=P)
    x, scale, pad = j_letterbox(jnp.asarray(FRAME)[None], input_hw, frame_hw)
    assert (scale, pad) == (0.5, (0, 32))
    v = seeded_variables(jnet, x, seed=60)
    j = jinfer.AutoSpeedInfer(variables=v, frame_hw=frame_hw, input_hw=input_hw)
    t = tinfer.AutoSpeedInfer(variables=v, frame_hw=frame_hw, input_hw=input_hw,
                              device="cpu")
    pred_j = np.array(jax.jit(jnet.apply)(v, x))
    seen = []
    hook = t.model.register_forward_hook(lambda m, a, y: seen.append(y))
    t.inference(FRAME)
    hook.remove()
    np.testing.assert_allclose(seen[0].numpy(), pred_j, atol=ATOL, rtol=RTOL)
    t.model.register_forward_hook(lambda m, a, y: torch.from_numpy(pred_j))
    got = t.inference(FRAME)
    j.model = types.SimpleNamespace(apply=lambda variables, x: jnp.asarray(pred_j))
    with jax.disable_jit():
        want = j.inference(FRAME)
    assert got.dtype == np.float32 and got.shape[1] == 6 and 0 < len(got) <= 64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="built for"):
        t.inference(FRAME[:64])


def test_autosteer_wrapper():
    """Two raw (80, 160, 3) logit maps -> degrees: argmax(current) - 30."""
    rng = np.random.default_rng(61)
    prev, curr = (rng.standard_normal((80, 160, 3)).astype(np.float32) for _ in range(2))
    jnet = JSteer(precision=P)
    stacked = np.concatenate([prev, curr], -1)[None]
    v = seeded_variables(jnet, stacked, seed=62)
    j = jinfer.AutoSteerInfer(variables=v)
    t = tinfer.AutoSteerInfer(variables=v, device="cpu")
    logits_j = np.asarray(jax.jit(jnet.apply)(v, stacked)[1])[0]
    with torch.no_grad():
        logits_t = t.model(to_port(stacked))[1][0].numpy()
    np.testing.assert_allclose(logits_t, logits_j, atol=ATOL, rtol=RTOL)
    top = np.sort(logits_t)
    assert top[-1] - top[-2] > DECIDED
    deg = t.inference(prev, curr)
    assert isinstance(deg, float) and deg == j.inference(prev, curr)
    assert deg == float(np.argmax(logits_t)) - 30.0


def test_backend_from_params_loads_a_jax_weight_file(tmp_path):
    """A DomainSeg weight file written by the JAX package's save_msgpack:
    the stem picks the family, fp32 runs f32, the weights load from the
    file, and do_inference gives the raw forward of DomainSegInfer
    built from the same variables, (h, w, C) f32, bit for bit."""
    spec = jax.ShapeDtypeStruct((1, 320, 640, 3), jnp.float32)
    v = seeded_variables(JDomain(precision=P), spec, seed=90)
    path = tmp_path / "domain_seg_v2.msgpack"
    save_msgpack(path, v)
    dtype = torch.float32
    b = tbackend.backend_from_params({"model_path": str(path), "model_type": "segmentation",
                                      "precision": "fp32"}, device="cpu")
    assert isinstance(b, tbackend.InferenceBackend)
    assert isinstance(b.model, DomainSegNetwork) and b.dtype == dtype
    assert b.model_type == "segmentation"
    frame = np.random.default_rng(91).integers(0, 256, (640, 1280, 3), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="do_inference first"):
        b.get_tensor_shape()
    got = b.do_inference(frame)
    assert got.dtype == np.float32 and got.shape == b.get_tensor_shape() == (320, 640, 1)
    w = tinfer.DomainSegInfer(variables=v, dtype=dtype, device="cpu")
    want = w.logits(torch.from_numpy(frame))[0].float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params,cls,dtype", [
    ({"model_path": "/no/such/dir/scene_3d.msgpack"}, Scene3DNetwork, torch.bfloat16),
    ({"model_path": "x/Ego_Lanes_best.msgpack", "precision": "bf16"}, EgoLanesNetwork,
     torch.bfloat16),
    ({"model_path": "scene_seg.msgpack", "precision": "fp32"}, SceneSegNetwork, torch.float32),
    ({"model_type": "depth", "precision": "int8"}, Scene3DNetwork, torch.float32),
    ({"model_type": "egolanes"}, EgoLanesNetwork, torch.bfloat16),
    ({"model_type": "unknown"}, SceneSegNetwork, torch.bfloat16),
    ({}, SceneSegNetwork, torch.bfloat16),
], ids=["stem-3d", "stem-lanes", "stem-seg", "type-depth", "type-lanes", "type-unknown",
        "empty"])
def test_backend_from_params_family_and_dtype(params, cls, dtype):
    """The file stem selects the family, else model_type (segmentation,
    depth, egolanes; anything else SceneSeg); 'fp16' (the default) and
    'bf16' run bf16, anything else f32; a path that does not exist keeps
    the seeded weights."""
    b = tbackend.backend_from_params(params, device="cpu")
    assert type(b.model) is cls and b.dtype == dtype
    assert next(b.model.parameters()).dtype == dtype
    assert b.model_type == params.get("model_type", "segmentation")
