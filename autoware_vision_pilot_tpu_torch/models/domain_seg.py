"""DomainSeg, the port of autoware_vision_pilot_tpu/models/domain_seg.py:
binary roadwork-zone segmentation, the SceneSeg backbone, context and neck
(the frozen upstream) -> a 1-class seg head. Submodule names are the JAX
package's. In train mode the upstream stays in eval mode and its outputs
are detached, as in the JAX package; only the head trains.
"""
from __future__ import annotations

from torch import nn

from .components import ContextBlock, SegHead, UNeck
from .efficientnet import EfficientNetB0Features


class _DomainSegUpstream(nn.Module):
    def __init__(self, ctx_hw=(10, 20), *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.pretrainedBackBone = EfficientNetB0Features(**kw)
        self.pretrainedContext = ContextBlock(1280, *ctx_hw, **kw)
        self.pretrainedNeck = UNeck(1280, **kw)

    def forward(self, image):
        """-> (neck (B, 256, H/4, W/4), the B0 pyramid)."""
        features = self.pretrainedBackBone(image)
        context = self.pretrainedContext(features[4])
        return self.pretrainedNeck(context, features), features


class DomainSegNetwork(nn.Module):
    def __init__(self, ctx_hw=(10, 20), *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.DomainSegUpstream = _DomainSegUpstream(ctx_hw, **kw)
        self.DomainSegHead = SegHead(1, **kw)

    def train(self, mode=True):
        super().train(mode)
        self.DomainSegUpstream.eval()
        return self

    def forward(self, image):
        """image: (B, 3, H, W) -> roadwork logits (B, 1, H, W)."""
        neck, features = self.DomainSegUpstream(image)
        if self.training:
            neck, features = neck.detach(), [f.detach() for f in features]
        return self.DomainSegHead(neck, features)
