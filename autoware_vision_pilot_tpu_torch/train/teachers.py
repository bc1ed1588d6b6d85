"""Pseudo-labeling teachers for the Lite trainer, the port of
autoware_vision_pilot_tpu/train/teachers.py.

The reference's Lite trainer labels unlabeled batches with relative depth
from a DepthAnythingV2 model (Models/training/lite_trainer_base.py:
249-278, encoders vits/vitb/vitl/vitg); train/lite_trainer.py takes such
a teacher as its ``pseudo_labeler(images_u8) -> labels`` hook. The
teacher is a PyTorch model from ``transformers.AutoModelForDepthEstimation``
(the official Depth-Anything-V2 releases), which is imported only when no
model and processor are given: nothing is downloaded here, so a host
without the weights in its local cache injects both (as the tests do with
stand-ins). It runs on the card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the reference's encoder names -> the model ids of the same releases
DEPTH_ANYTHING_V2_MODELS = {
    "vits": "depth-anything/Depth-Anything-V2-Small-hf",
    "vitb": "depth-anything/Depth-Anything-V2-Base-hf",
    "vitl": "depth-anything/Depth-Anything-V2-Large-hf",
}


class DepthAnythingTeacher:
    """A ``pseudo_labeler`` of per-image relative depth in [0, 1]:
    ``teacher(images_u8 (B, H, W, 3) uint8 RGB) -> (B, H, W) float32``
    (``target_hw`` instead of (H, W) when given). The SSI-mAE loss
    (train/losses.py::ssi_mae_depth_loss) is scale and shift invariant, so
    the per-image min-max normalization fixes only the range."""

    def __init__(self, encoder: str = "vitl", model: Any = None, processor: Any = None,
                 device="cuda", target_hw: Optional[Tuple[int, int]] = None):
        if encoder not in DEPTH_ANYTHING_V2_MODELS:
            raise ValueError(f"Invalid pseudo-labeler encoder type '{encoder}'. "
                             f"Choose from {sorted(DEPTH_ANYTHING_V2_MODELS)}.")
        self.device = torch.device(device)
        self.target_hw = target_hw
        if model is None or processor is None:
            from transformers import AutoImageProcessor, AutoModelForDepthEstimation
            name = DEPTH_ANYTHING_V2_MODELS[encoder]
            processor = processor or AutoImageProcessor.from_pretrained(name,
                                                                        local_files_only=True)
            model = model or AutoModelForDepthEstimation.from_pretrained(name,
                                                                         local_files_only=True)
        self.model = model.to(self.device).eval() if hasattr(model, "to") else model
        self.processor = processor

    @torch.no_grad()
    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        images = np.asarray(images_u8)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected (B,H,W,3) uint8, got {images.shape}")
        h, w = self.target_hw or images.shape[1:3]
        inputs = self.processor(images=list(images), return_tensors="pt")
        inputs = {k: v.to(self.device) if hasattr(v, "to") else v for k, v in inputs.items()}
        depth = self.model(**inputs).predicted_depth  # (B, h', w')
        if depth.ndim == 3:
            depth = depth[:, None]
        depth = F.interpolate(depth, size=(h, w), mode="bilinear", align_corners=False)[:, 0]
        d = depth.float().cpu().numpy()
        lo = d.min(axis=(1, 2), keepdims=True)
        hi = d.max(axis=(1, 2), keepdims=True)
        return ((d - lo) / np.maximum(hi - lo, 1e-8)).astype(np.float32)
