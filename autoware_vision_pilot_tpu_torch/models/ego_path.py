"""The EgoPath / AutoSteer 1.0 legacy modules, the port of
autoware_vision_pilot_tpu/models/ego_path.py: the 1456-channel context
block and the temporal steering head that fuses the current reduced neck
features with the previous frame's and regresses a scalar steering angle.
Submodule names are the JAX package's. Dropout is the identity in eval
mode, the only mode here.
"""
from __future__ import annotations

from torch import nn

from ..nn.layers import Conv2d, Linear, gelu, max_pool2d
from .components import ContextBlock


class BEVPathContext(ContextBlock):
    """The 1456-channel context block (bev_path_context.py): the same layers
    and forward as ContextBlock. The reference's trailing 2x ConvTranspose
    ``upsample_layer`` is never called; like the JAX module, this one does
    not declare it, so the JAX variables load with strict=True."""

    def __init__(self, in_ch=1456, ctx_h=10, ctx_w=20, *, device=None, dtype=None):
        super().__init__(in_ch, ctx_h, ctx_w, device=device, dtype=dtype)


class AutoSteerHead(nn.Module):
    """Temporal steering head (auto_steer_head.py): pool the neck to the
    context size, pseudo-attention, a 3-conv reduction, the spatio-temporal
    concat (along W) with the previous frame's features, and a Linear(800)
    -> Linear(1) steering regression from the flattened pre-activation
    reduced features. ``feature_prev`` is the ``feature`` of the frame
    before.

    The flax ``Linear(800)`` of ``steering_decode_layer`` sizes itself from
    its input; here its input size is given: 64 * ctx_h * ctx_w (12,800 for
    the 10x20 context of a 320x640 frame). The flatten is the natural
    (C, H, W) one, as the reference's torch.flatten, per sample."""

    def __init__(self, in_ch=256, ctx_h=10, ctx_w=20, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.neck_reduce_layer_1 = Conv2d(in_ch, 128, 3, 1, 1, **kw)
        self.neck_reduce_layer_2 = Conv2d(128, 64, 3, 1, 1, **kw)
        self.neck_reduce_layer_3 = Conv2d(64, 64, 3, 1, 1, **kw)
        self.decode_layer_1 = Conv2d(64, 64, 3, 1, 1, **kw)
        self.decode_layer_2 = Conv2d(64, 64, 3, 1, 1, **kw)
        self.decode_layer_3 = Conv2d(64, 1, 3, 1, 1, **kw)
        self.steering_decode_layer = Linear(64 * ctx_h * ctx_w, 800, **kw)
        self.steering_output = Linear(800, 1, **kw)

    def forward(self, context, neck, feature_prev):
        """context (B, in_ch, ctx_h, ctx_w), neck (B, in_ch, 4 ctx_h,
        4 ctx_w), feature_prev (B, 64, ctx_h, ctx_w) -> (angle (B, 1),
        feature (B, 64, ctx_h, ctx_w))."""
        p0 = max_pool2d(max_pool2d(neck, 2, 2), 2, 2)
        p0 = p0 * context + context
        p1 = gelu(self.neck_reduce_layer_1(p0))
        p2 = gelu(self.neck_reduce_layer_2(p1))
        p3 = self.neck_reduce_layer_3(p2)
        feature = gelu(p3)

        # The JAX module also runs decode_layer_1..3 on the W concat of
        # feature and feature_prev and returns nothing of it: under jit XLA
        # removes that work, and so does this module. Their weights load.
        angle = gelu(self.steering_decode_layer(p3.reshape(p3.shape[0], -1)))
        return self.steering_output(angle), feature
