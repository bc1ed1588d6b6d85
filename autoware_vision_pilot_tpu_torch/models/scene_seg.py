"""SceneSeg, the port of autoware_vision_pilot_tpu/models/scene_seg.py:
3-class drivable-scene segmentation (background / foreground / small
objects) at 320x640: EfficientNet-B0 encoder -> global-context attention ->
ConvTranspose U-neck -> seg head. Submodule names are the JAX package's.
"""
from __future__ import annotations

from torch import nn

from .components import ContextBlock, SegHead, UNeck
from .efficientnet import B0_STAGES, EfficientNetB0Features


class SceneSegNetwork(nn.Module):
    def __init__(self, ctx_hw=(10, 20), backbone_stages=B0_STAGES, *, device=None,
                 dtype=None):
        """``ctx_hw`` is the stride-32 map of the input (10x20 at 320x640);
        ``backbone_stages`` B0_DRYRUN_STAGES gives a shallow trunk with the
        same taps."""
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.Backbone = EfficientNetB0Features(backbone_stages, **kw)
        self.SceneContext = ContextBlock(1280, *ctx_hw, **kw)
        self.SceneNeck = UNeck(1280, **kw)
        self.SceneSegHead = SegHead(3, **kw)

    def forward(self, image):
        """image: (B, 3, H, W) -> class logits (B, 3, H, W)."""
        features = self.Backbone(image)
        context = self.SceneContext(features[4])
        return self.SceneSegHead(self.SceneNeck(context, features), features)
