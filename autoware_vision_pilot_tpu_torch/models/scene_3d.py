"""Scene3D, the port of autoware_vision_pilot_tpu/models/scene_3d.py:
monocular relative depth at 320x640, the SceneSeg backbone -> DepthContext
-> DepthNeck -> a 1-channel depth head. Submodule names are the JAX
package's. Freezing the pretrained backbone is the trainer's concern, as in
the JAX package; these modules run in eval mode.
"""
from __future__ import annotations

from torch import nn

from .components import ContextBlock, DepthHead, UNeck
from .efficientnet import EfficientNetB0Features


class _PreTrainedBackbone(nn.Module):
    def __init__(self, *, device=None, dtype=None):
        super().__init__()
        self.pretrainedBackBone = EfficientNetB0Features(device=device, dtype=dtype)

    def forward(self, image):
        return self.pretrainedBackBone(image)


class Scene3DNetwork(nn.Module):
    def __init__(self, ctx_hw=(10, 20), *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.PreTrainedBackbone = _PreTrainedBackbone(**kw)
        self.DepthContext = ContextBlock(1280, *ctx_hw, **kw)
        self.DepthNeck = UNeck(1280, **kw)
        self.SuperDepthHead = DepthHead(**kw)

    def forward(self, image):
        """image: (B, 3, H, W) -> relative depth (B, 1, H, W)."""
        features = self.PreTrainedBackbone(image)
        context = self.DepthContext(features[4])
        return self.SuperDepthHead(self.DepthNeck(context, features), features)
