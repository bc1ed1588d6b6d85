"""The port's per-network inference wrappers (inference/infer.py) for the
seg networks (SceneSeg, Scene3D, DomainSeg, EgoLanes) against the JAX
package's, on the CPU in f32.

Weights and frames are drawn with numpy from seeds; the JAX variables go
to both sides (the port loads them through convert/from_jax.py, strictly).
The seg wrappers at a 64x128 input with ctx_hw=(2, 4) (SceneSeg and
EgoLanes at dryrun depth, Scene3D and DomainSeg at full depth), fed
128x256 frames: a factor 2 resize, where both packages' preprocess gives
the same bits. What is held, and why:
- the raw forward (``logits``, ``inference_raw``) and Scene3D's scaled
  depth: atol 2e-4, rtol 1e-3 (tests/test_models_parity.py's bar);
- the masks (argmax, > threshold) exactly, wherever the port's own logits
  decide them by more than DECIDED (a class margin, or a distance from the
  threshold; the networks agree to ~1e-5 there): at least 99 % of them.
The networks themselves: tests/test_torch_seg_nets.py; the AutoSpeed and
AutoSteer wrappers and the backend: tests/test_torch_backend.py; the int8
wrappers, conv by conv: tests/test_torch_infer_int8.py.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.inference import infer as jinfer
from autoware_vision_pilot_tpu.models.domain_seg import DomainSegNetwork as JDomain
from autoware_vision_pilot_tpu.models.efficientnet import B0_DRYRUN_STAGES as J_DRYRUN
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JLanes
from autoware_vision_pilot_tpu.models.scene_3d import Scene3DNetwork as JScene3D
from autoware_vision_pilot_tpu.models.scene_seg import SceneSegNetwork as JSceneSeg

from autoware_vision_pilot_tpu_torch import inference as tinfer
from autoware_vision_pilot_tpu_torch import middleware as tmiddleware
from autoware_vision_pilot_tpu_torch.middleware import backend as tbackend
from autoware_vision_pilot_tpu_torch.models import (DomainSegNetwork, EgoLanesNetwork,
                                                    Scene3DNetwork, SceneSegNetwork)
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES

from test_torch_layers import P, seeded_variables
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

IN_HW, CTX = (64, 128), (2, 4)
FRAME = np.random.default_rng(0).integers(0, 256, (128, 256, 3), dtype=np.uint8)
DECIDED = 1e-3
ATOL, RTOL = 2e-4, 1e-3

# name -> (JAX network, port network, JAX wrapper, port wrapper)
NETS = {
    "scene_seg": (lambda: JSceneSeg(ctx_hw=CTX, backbone_stages=J_DRYRUN, precision=P),
                  lambda: SceneSegNetwork(CTX, B0_DRYRUN_STAGES),
                  jinfer.SceneSegInfer, tinfer.SceneSegInfer),
    "scene_3d": (lambda: JScene3D(ctx_hw=CTX, precision=P), lambda: Scene3DNetwork(CTX),
                 jinfer.Scene3DInfer, tinfer.Scene3DInfer),
    "domain_seg": (lambda: JDomain(ctx_hw=CTX, precision=P), lambda: DomainSegNetwork(CTX),
                   jinfer.DomainSegInfer, tinfer.DomainSegInfer),
    "ego_lanes": (lambda: JLanes(ctx_hw=CTX, backbone_stages=J_DRYRUN, precision=P),
                  lambda: EgoLanesNetwork(CTX, B0_DRYRUN_STAGES),
                  jinfer.EgoLanesInfer, tinfer.EgoLanesInfer),
}


def decided(logits, name):
    """Where the port's logits (1, h, w, C) decide the wrapper's mask by
    more than DECIDED."""
    if name == "scene_seg":
        top = np.sort(logits[0], axis=-1)
        return top[..., -1] - top[..., -2] > DECIDED
    if name == "domain_seg":
        return np.abs(logits[0, ..., 0]) > DECIDED
    return np.abs(logits[0]) > DECIDED


@pytest.mark.parametrize("name", list(NETS))
def test_wrapper(name):
    jnet, port_net, jwrap, twrap = NETS[name]
    spec = jax.ShapeDtypeStruct((1, *IN_HW, 3), jnp.float32)
    v = seeded_variables(jnet(), spec, seed=50 + list(NETS).index(name))
    j = jwrap(model=jnet(), variables=v, input_hw=IN_HW)
    t = twrap(model=port_net(), variables=v, input_hw=IN_HW, device="cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    logits = t.logits(torch.from_numpy(FRAME)).numpy()
    got, want = t.inference(FRAME), j.inference(FRAME)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if name == "scene_3d":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        assert got.min() == 0 and got.max() == 1
        return
    where = decided(logits, name)
    assert where.mean() > 0.99, name
    np.testing.assert_array_equal(got[where], want[where], err_msg=name)
    if name == "ego_lanes":
        raw = t.inference_raw(FRAME)
        np.testing.assert_array_equal(raw, logits[0])
        np.testing.assert_allclose(raw, j.inference_raw(FRAME), atol=ATOL, rtol=RTOL)


def test_wrappers_default_to_the_card():
    """Every wrapper and backend_from_params takes device="cuda" unless told
    otherwise, and f32 as the JAX wrappers' jnp.float32; without a card the
    build raises: nothing carries on on the CPU."""
    for fn in (tinfer.infer._Base.__init__, tinfer.AutoSpeedInfer.__init__,
               tinfer.AutoSteerInfer.__init__, tbackend.backend_from_params):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda", fn
        if "dtype" in params:
            assert params["dtype"].default == torch.float32, fn
    assert set(dir(tinfer)) >= {"SceneSegInfer", "Scene3DInfer", "DomainSegInfer",
                                "EgoLanesInfer", "AutoSpeedInfer", "AutoSteerInfer"}
    assert set(dir(tmiddleware)) >= {"InferenceBackend", "TorchInferenceBackend",
                                     "backend_from_params"}
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tinfer.AutoSteerInfer()
    with pytest.raises(ValueError, match="precision"):
        tinfer.SceneSegInfer(model=SceneSegNetwork(CTX, B0_DRYRUN_STAGES), input_hw=IN_HW,
                             precision="fp8", device="cpu")
