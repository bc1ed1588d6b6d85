"""EgoLanes, the port of autoware_vision_pilot_tpu/models/ego_lanes.py:
EfficientNet-B0 -> pyramid max-pool fusion (1456 ch) -> context attention
-> U-neck -> quarter-res 3-channel lane head (80x160 for a 320x640 input).
"""
from __future__ import annotations

from torch import nn

from .components import BackboneFeatureFusion, ContextBlock, EgoLanesHead, UNeck
from .efficientnet import B0_STAGES, EfficientNetB0Features


class EgoLanesNetwork(nn.Module):
    def __init__(self, ctx_hw=(10, 20), backbone_stages=None, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.BEVBackbone = EfficientNetB0Features(
            backbone_stages or B0_STAGES, **kw)
        self.BackboneFeatureFusion = BackboneFeatureFusion()
        self.AutoSteerContext = ContextBlock(1456, *ctx_hw, **kw)
        self.EgopathNeck = UNeck(1456, **kw)
        self.EgoLanesHead = EgoLanesHead(**kw)

    def forward(self, image):
        """image: (B, 3, H, W) -> lane logits (B, 3, H/4, W/4)."""
        features = self.BEVBackbone(image)
        fused = self.BackboneFeatureFusion(features)
        context = self.AutoSteerContext(fused)
        return self.EgoLanesHead(self.EgopathNeck(context, features))
