"""The Lite models, the port of autoware_vision_pilot_tpu/models/lite."""
from .deeplabv3plus import DeepLabV3Plus
from .unetplusplus import UnetPlusPlus


def build_lite_model(cfg: dict, **overrides):
    """Build a Lite model from an experiment config's ``network`` section
    (model / backbone / decoder / head / output_channels keys), as the JAX
    package's ``build_lite_model`` does. ``overrides`` go to the model's
    constructor (``device``, ``dtype``, or a field that the config would
    set). Raises ValueError on an unknown ``model``."""
    net = cfg.get("network", cfg)
    backbone = net.get("backbone", {}) or {}
    decoder = net.get("decoder", {}) or {}
    head = net.get("head", {}) or {}
    kind = net.get("model", "deeplabv3plus")
    common = dict(
        encoder_name=backbone.get("type", "efficientnet_b0"),
        output_channels=int(net.get("output_channels", 3)),
        head_activation=head.get("head_activation") or None,
    )
    common.update(overrides)
    if kind == "unetplusplus":
        if "head_upsampling" in head:
            common.setdefault("head_upsampling", int(head["head_upsampling"]))
        return UnetPlusPlus(**common)
    if kind != "deeplabv3plus":
        raise ValueError(f"unknown lite model {kind!r}")
    common.setdefault("output_stride", int(backbone.get("output_stride", 16)))
    if "aspp_dilations" in decoder:
        common.setdefault("atrous_rates", tuple(decoder["aspp_dilations"]))
    if "deeplabv3plus_decoder_channels" in decoder:
        common.setdefault("decoder_channels", int(decoder["deeplabv3plus_decoder_channels"]))
    if "head_upsampling" in head:
        common.setdefault("head_upsampling", int(head["head_upsampling"]))
    return DeepLabV3Plus(**common)
