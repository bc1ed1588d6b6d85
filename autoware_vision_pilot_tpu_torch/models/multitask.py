"""Fused multi-task perception stack, the port of
autoware_vision_pilot_tpu/models/multitask.py::SharedPerceptionStack.

One EfficientNet-B0 trunk per frame feeds the SceneSeg branch (context,
U-neck, seg head), the Scene3D branch (own context and U-neck, depth head)
and, with ``with_domain``, the DomainSeg head on the SceneSeg neck.
Submodule names are the JAX package's, so state_dict keys match it.
"""
from __future__ import annotations

from torch import nn

from .components import ContextBlock, DepthHead, SegHead, UNeck
from .efficientnet import EfficientNetB0Features


class SharedPerceptionStack(nn.Module):
    def __init__(self, ctx_hw=(10, 20), with_domain=True, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.Backbone = EfficientNetB0Features(**kw)
        self.SceneContext = ContextBlock(1280, *ctx_hw, **kw)
        self.SceneNeck = UNeck(1280, **kw)
        self.SceneSegHead = SegHead(3, **kw)
        self.DepthContext = ContextBlock(1280, *ctx_hw, **kw)
        self.DepthNeck = UNeck(1280, **kw)
        self.SuperDepthHead = DepthHead(**kw)
        self.DomainSegHead = SegHead(1, **kw) if with_domain else None

    def forward(self, image):
        """image: (B, 3, H, W) -> (seg (B,3,H,W), depth (B,1,H,W),
        domain (B,1,H,W) or None)."""
        feats = self.Backbone(image)
        s_neck = self.SceneNeck(self.SceneContext(feats[4]), feats)
        seg = self.SceneSegHead(s_neck, feats)
        d_neck = self.DepthNeck(self.DepthContext(feats[4]), feats)
        depth = self.SuperDepthHead(d_neck, feats)
        domain = None
        if self.DomainSegHead is not None:
            domain = self.DomainSegHead(s_neck, feats)
        return seg, depth, domain


def import_from_individual_checkpoints(stack_state, scene_seg_state, scene_3d_state=None,
                                       domain_seg_state=None):
    """Map the separate networks' state_dicts onto the fused stack's, the
    port of the JAX package's function of the same name, which maps flax
    trees: each named subtree of a source replaces the stack's subtree of
    that name whole. Returns a new state_dict for ``stack.load_state_dict``.

    scene_seg_state: a SceneSegNetwork's (Backbone, SceneContext,
    SceneNeck, SceneSegHead copied 1:1). scene_3d_state: a Scene3DNetwork's
    (DepthContext, DepthNeck, SuperDepthHead; its PreTrainedBackbone must
    equal SceneSeg's Backbone). domain_seg_state: a DomainSegNetwork's
    (DomainSegHead).
    """
    out = dict(stack_state)

    def merge(src, names):
        for name in names:
            taken = {k: v for k, v in src.items() if k.startswith(name + ".")}
            if not taken:
                continue
            for k in [k for k in out if k.startswith(name + ".")]:
                del out[k]
            out.update(taken)

    merge(scene_seg_state, ("Backbone", "SceneContext", "SceneNeck", "SceneSegHead"))
    if scene_3d_state is not None:
        merge(scene_3d_state, ("DepthContext", "DepthNeck", "SuperDepthHead"))
    if domain_seg_state is not None:
        merge(domain_seg_state, ("DomainSegHead",))
    return out
