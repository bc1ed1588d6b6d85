"""Thin inference wrappers per network, the port of
autoware_vision_pilot_tpu/inference/infer.py (the reference's
Models/inference/*_infer.py): weights -> eval -> preprocess -> forward ->
the task's post-processing, numpy BGR frames in, numpy out.

Each wrapper keeps ``_fwd``, its device work on a uint8 frame already on
its device (the preprocess kernel, the network, the post-processing),
as the JAX wrapper keeps its jitted ``_fwd``; ``inference`` uploads the
frame, runs ``_fwd`` and copies the result back. Wrappers run on the card
unless given ``device="cpu"``; on the CPU the kernels' plain versions run
(ops/kernels/*). Weights: ``variables``, the JAX package's tree as numpy
(loaded through convert/from_jax.py, strictly), else the flax msgpack file
``checkpoint`` (export/checkpoints.py::load_msgpack), else drawn from seed 0
(nn/layers.py::init_seeded) on the CPU, the same on every device, as the
JAX wrapper draws its from key(0).
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert.from_jax import variables_to_state_dict
from ..export.checkpoints import load_msgpack
from ..export.quantize import calibrate_int8_activation_scales, quantize_for_int8_conv
from ..nn.layers import init_seeded
from ..ops.kernels.nms_kernel import nms_fixed
from ..ops.kernels.preprocess_kernel import fused_letterbox, fused_preprocess
from ..ops.postprocess import (argmax_mask, decode_yolo_to_original, depth_minmax_scale,
                               threshold_channels)
from ..pipeline import calibration_batches

CL = torch.channels_last


def load_weights(model: nn.Module, variables=None, checkpoint: str = "", device="cuda",
                 dtype=torch.float32) -> nn.Module:
    """``model`` (built on the CPU in f32) with its weights: ``variables``
    (a JAX variables tree), else the msgpack file ``checkpoint``, else
    drawn from seed 0; then moved to ``device`` in ``dtype``,
    channels_last, in eval mode."""
    if variables is None:
        init_seeded(model, torch.Generator().manual_seed(0))
        if checkpoint:
            variables = load_msgpack(checkpoint)
    if variables is not None:
        model.load_state_dict(variables_to_state_dict(variables, model), strict=True)
    model.to(device=device, dtype=dtype, memory_format=CL)
    return model.eval()


def _upload(frame_bgr_u8: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frame_bgr_u8, dtype=np.uint8)).to(device)


def forward_nhwc(model: nn.Module, frame: torch.Tensor, input_hw: Tuple[int, int],
                 dtype: torch.dtype) -> torch.Tensor:
    """A uint8 BGR frame (H, W, 3) on ``model``'s device -> the preprocess
    kernel -> ``model`` -> its output NHWC in ``dtype``: the raw forward of
    the wrappers and of middleware/backend.py."""
    return model(fused_preprocess(frame, input_hw, dtype)).permute(0, 2, 3, 1)


class _Base:
    def __init__(self, model: nn.Module, variables=None, checkpoint: str = "",
                 input_hw: Tuple[int, int] = (320, 640), dtype: torch.dtype = torch.float32,
                 precision: str = "float", int8_min_channels: int = 128,
                 int8_calibration: Optional[Iterable[torch.Tensor]] = None,
                 device="cuda"):
        """precision: 'float' keeps the weights as they are; 'int8' swaps
        every conv with at least ``int8_min_channels`` input channels for
        an int8 conv (export/quantize.py::quantize_for_int8_conv) and
        calibrates static activation scales on ``int8_calibration``, model
        inputs (1, 3, h, w) on ``device``; by default the four N(0, 1)
        batches of ``np.random.default_rng(7)`` that the JAX wrapper
        draws (pipeline.py::calibration_batches)."""
        if precision not in ("float", "int8"):
            raise ValueError(f"precision must be 'float' or 'int8', got {precision!r}")
        self.input_hw = tuple(input_hw)
        self.dtype = dtype
        self.device = torch.device(device)
        self.model = load_weights(model, variables, checkpoint, device, dtype)
        if precision == "int8":
            quantize_for_int8_conv(self.model, int8_min_channels)
            if int8_calibration is None:
                int8_calibration = calibration_batches(self.input_hw, dtype, self.device)
            calibrate_int8_activation_scales(self.model, int8_calibration)

    @torch.inference_mode()
    def logits(self, frame: torch.Tensor) -> torch.Tensor:
        """A uint8 BGR frame (H, W, 3) on the wrapper's device -> the
        network's output for it, NHWC in the model dtype (the raw forward)."""
        return forward_nhwc(self.model, frame, self.input_hw, self.dtype)


class SceneSegInfer(_Base):
    def __init__(self, **kw):
        from ..models.scene_seg import SceneSegNetwork
        if kw.get("model") is None:
            kw["model"] = SceneSegNetwork(device="cpu", dtype=torch.float32)
        super().__init__(**kw)

    def _fwd(self, frame):
        return argmax_mask(self.logits(frame).float())[0]

    def inference(self, frame_bgr_u8: np.ndarray) -> np.ndarray:
        """-> (H, W) int32 class ids (0 bg / 1 fg / 2 road)."""
        return self._fwd(_upload(frame_bgr_u8, self.device)).cpu().numpy()


class Scene3DInfer(_Base):
    def __init__(self, **kw):
        from ..models.scene_3d import Scene3DNetwork
        if kw.get("model") is None:
            kw["model"] = Scene3DNetwork(device="cpu", dtype=torch.float32)
        super().__init__(**kw)

    def _fwd(self, frame):
        return depth_minmax_scale(self.logits(frame).float())[0, ..., 0]

    def inference(self, frame_bgr_u8: np.ndarray) -> np.ndarray:
        """-> (H, W) float32 relative depth in [0, 1]."""
        return self._fwd(_upload(frame_bgr_u8, self.device)).cpu().numpy()


class DomainSegInfer(_Base):
    def __init__(self, threshold: float = 0.0, **kw):
        from ..models.domain_seg import DomainSegNetwork
        if kw.get("model") is None:
            kw["model"] = DomainSegNetwork(device="cpu", dtype=torch.float32)
        super().__init__(**kw)
        self.threshold = threshold

    def _fwd(self, frame):
        return self.logits(frame).float()[0, ..., 0] > self.threshold

    def inference(self, frame_bgr_u8: np.ndarray) -> np.ndarray:
        """-> (H, W) bool roadwork mask."""
        return self._fwd(_upload(frame_bgr_u8, self.device)).cpu().numpy()


class EgoLanesInfer(_Base):
    def __init__(self, threshold: float = 0.0, **kw):
        from ..models.ego_lanes import EgoLanesNetwork
        if kw.get("model") is None:
            kw["model"] = EgoLanesNetwork(device="cpu", dtype=torch.float32)
        super().__init__(**kw)
        self.threshold = threshold

    def _fwd(self, frame):
        """-> (raw logits, thresholded masks), each (H/4, W/4, 3) f32."""
        logits = self.logits(frame).float()
        return logits[0], threshold_channels(logits, self.threshold)[0]

    def inference(self, frame_bgr_u8: np.ndarray) -> np.ndarray:
        """-> (H/4, W/4, 3) float binary masks [ego_left, ego_right, other]."""
        return self._fwd(_upload(frame_bgr_u8, self.device))[1].cpu().numpy()

    def inference_raw(self, frame_bgr_u8: np.ndarray) -> np.ndarray:
        """-> (H/4, W/4, 3) raw pre-threshold logits, the tensor the
        temporal AutoSteer consumes (main.cpp:516-524 copies
        getRawTensorData(), not the thresholded masks)."""
        return self._fwd(_upload(frame_bgr_u8, self.device))[0].cpu().numpy()


class AutoSpeedInfer:
    """Letterbox (the letterbox kernel) -> AutoSpeed -> decode ->
    fixed-shape NMS (the NMS kernel) at the reference's thresholds.
    ``model``: the AutoSpeedNetwork for ``input_hw``, built on the CPU in
    f32 (default: "n" with 4 classes), its weights loaded as load_weights
    says."""

    def __init__(self, variables=None, checkpoint: str = "", frame_hw=(720, 1280),
                 input_hw=(640, 640), conf_thresh: float = 0.25, iou_thresh: float = 0.45,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 model: Optional[nn.Module] = None):
        from ..models.auto_speed import AutoSpeedNetwork
        self.frame_hw, self.input_hw = tuple(frame_hw), tuple(input_hw)
        self.conf_thresh, self.iou_thresh = conf_thresh, iou_thresh
        self.dtype = dtype
        self.device = torch.device(device)
        if model is None:
            model = AutoSpeedNetwork("n", 4, *input_hw, device="cpu", dtype=torch.float32)
        self.model = load_weights(model, variables, checkpoint, device, dtype)

    @torch.inference_mode()
    def _fwd(self, frame):
        """-> (boxes (64, 4), scores (64,), classes (64,) int32, valid (64,)
        bool), zeros where not valid."""
        if tuple(frame.shape[:2]) != self.frame_hw:
            raise ValueError(f"frame {tuple(frame.shape)}, the wrapper is built for "
                             f"{self.frame_hw}")
        x, scale, pad = fused_letterbox(frame, self.input_hw, self.dtype)
        pred = self.model(x)[0].float()
        boxes, scores, cls = decode_yolo_to_original(pred, scale, pad, self.frame_hw)
        return nms_fixed(boxes, scores, cls, conf_thresh=self.conf_thresh,
                         iou_thresh=self.iou_thresh)

    def inference(self, frame_bgr_u8: np.ndarray) -> np.ndarray:
        """-> (N, 6) [x1, y1, x2, y2, score, class] in original pixels."""
        boxes, scores, cls, valid = (t.cpu().numpy() for t in
                                     self._fwd(_upload(frame_bgr_u8, self.device)))
        return np.concatenate([boxes[valid], scores[valid, None],
                               cls[valid, None].astype(np.float32)], axis=1)


class AutoSteerInfer:
    """Temporal steering classifier over two raw EgoLanes logit tensors.

    The reference feeds the raw pre-threshold EgoLanes output tensors of
    frames t-1 and t (main.cpp:516-524 copies ``getRawTensorData()``, not
    the thresholded masks): pass logits here, never binarized masks.
    """

    def __init__(self, variables=None, checkpoint: str = "",
                 dtype: torch.dtype = torch.float32, device="cuda"):
        from ..models.auto_steer_temporal import AutoSteerTemporalNet
        self.dtype = dtype
        self.device = torch.device(device)
        self.model = load_weights(AutoSteerTemporalNet(device="cpu", dtype=torch.float32),
                                  variables, checkpoint, device, dtype)

    @torch.inference_mode()
    def _fwd(self, stacked):
        """(80, 160, 6) f32 [t-1, t] logits on the device -> degrees (0-dim)."""
        from ..models.auto_steer_temporal import steering_from_logits
        x = stacked.permute(2, 0, 1)[None].to(self.dtype).contiguous(memory_format=CL)
        _, curr = self.model(x)
        return steering_from_logits(curr.float())[0]

    def inference(self, prev_logits: np.ndarray, curr_logits: np.ndarray) -> float:
        """logits: (80, 160, 3) raw EgoLanes tensors (pre-threshold), frames
        t-1 and t -> steering angle in degrees."""
        stacked = np.concatenate([prev_logits, curr_logits], axis=-1).astype(np.float32)
        return float(self._fwd(torch.from_numpy(stacked).to(self.device)))
