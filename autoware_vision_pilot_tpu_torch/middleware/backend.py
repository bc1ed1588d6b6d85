"""Generic inference backend interface for middleware nodes, the port of
autoware_vision_pilot_tpu/middleware/backend.py.

Mirror of the reference's common layer
(middleware_recipes/common/include/inference_backend_base.hpp:14-27):
``do_inference(image) -> raw tensor``, ``get_tensor_shape()``. The
concrete backend runs an eval-mode PyTorch network behind the preprocess
kernel; the device ("cuda", or "cpu" on request) replaces the reference's
onnxruntime/tensorrt switch (run_model_node.cpp:25-61).
"""
from __future__ import annotations

import pathlib
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..inference.infer import forward_nhwc, load_weights


class InferenceBackend:
    """Abstract: subclasses implement do_inference()."""

    def do_inference(self, image_bgr_u8: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def get_tensor_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError


class TorchInferenceBackend(InferenceBackend):
    """Wraps an eval-mode network, its weights in ``dtype`` on its device,
    into the backend interface.

    model_type: 'segmentation' | 'depth' | 'egolanes' (the run_model.cpp
    model_type switch) -- selects pre/post conventions.
    """

    def __init__(self, model: nn.Module, input_hw=(320, 640),
                 model_type: str = "segmentation", dtype: torch.dtype = torch.bfloat16):
        self.model = model
        self.input_hw = tuple(input_hw)
        self.model_type = model_type
        self.dtype = dtype
        self.device = next(model.parameters()).device
        self._shape: Optional[Tuple[int, ...]] = None

    @torch.inference_mode()
    def _fwd(self, frame: torch.Tensor) -> torch.Tensor:
        """A uint8 BGR frame (H, W, 3) on the device -> the network's output
        (h, w, C) f32, cast after the network: the wrappers' raw forward."""
        return forward_nhwc(self.model, frame, self.input_hw, self.dtype)[0].float()

    def do_inference(self, image_bgr_u8: np.ndarray) -> np.ndarray:
        frame = torch.from_numpy(np.ascontiguousarray(image_bgr_u8, dtype=np.uint8))
        out = self._fwd(frame.to(self.device)).cpu().numpy()
        self._shape = out.shape
        return out

    def get_tensor_shape(self) -> Tuple[int, ...]:
        if self._shape is None:
            raise RuntimeError("run do_inference first")
        return self._shape


def backend_from_params(p: dict, device="cuda") -> TorchInferenceBackend:
    """Build a backend from an autoseg.yaml-style parameter dict
    (model_path / model_type / precision keys; run_model_node.cpp:29-61
    parameter contract). model_path points at a msgpack checkpoint whose
    stem selects the network family ('scene_seg', 'scene_3d',
    'domain_seg', 'ego_lanes'), else model_type does; precision 'fp16' or
    'bf16' (the default 'fp16') runs bf16, anything else f32. Weights are
    drawn from seed 0, then replaced by the checkpoint's when the path
    exists."""
    from ..models import DomainSegNetwork, EgoLanesNetwork, Scene3DNetwork, SceneSegNetwork

    families = {"scene_seg": SceneSegNetwork, "scene_3d": Scene3DNetwork,
                "domain_seg": DomainSegNetwork, "ego_lanes": EgoLanesNetwork}
    path = p.get("model_path", "")
    stem = pathlib.Path(path).stem.lower() if path else ""
    cls = next((c for k, c in families.items() if k in stem), None)
    if cls is None:
        cls = {"segmentation": SceneSegNetwork, "depth": Scene3DNetwork,
               "egolanes": EgoLanesNetwork}.get(p.get("model_type", "segmentation"),
                                                SceneSegNetwork)
    dtype = torch.bfloat16 if p.get("precision", "fp16") in ("fp16", "bf16") else torch.float32
    checkpoint = path if path and pathlib.Path(path).exists() else ""
    model = load_weights(cls(device="cpu", dtype=torch.float32), checkpoint=checkpoint,
                         device=device, dtype=dtype)
    return TorchInferenceBackend(model, model_type=p.get("model_type", "segmentation"),
                                 dtype=dtype)
